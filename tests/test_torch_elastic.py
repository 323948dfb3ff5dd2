"""The port's elastic coordinator (`repro_torch.launch.elastic`) against
the JAX package's (`repro.launch.elastic`), on the CPU: the scenarios of
`tests/test_substrate.py` (divisibility, a failure restored and
reshaped, a straggler evicted, a scale-up), each event script run through
both coordinators, with the same `ElasticState`, log and checkpoint saves
asserted, and the reference test's own assertions on the port's state."""

import dataclasses

import pytest

from repro.launch import elastic as jelastic
from repro_torch.launch import elastic as telastic


class _Fleet:
    """Simulated fleet of hosts with injectable slow/failed hosts."""

    def __init__(self, hosts):
        self.hosts = hosts
        self.slow = set()

    def step(self, step, dp):
        return [3.0 if h in self.slow else 1.0 for h in range(self.hosts)]


def failure(mod):
    saved = []
    cfg = mod.ElasticConfig(total_hosts=8, model_parallel=4,
                            chips_per_host=4, checkpoint_every=5)
    co = mod.ElasticCoordinator(cfg, global_batch=64,
                                save_fn=lambda s: saved.append(s),
                                restore_fn=lambda: saved[-1] if saved else 0)
    fleet = _Fleet(8)
    events = {12: lambda c: c.on_host_failure(3)}
    return co.run(fleet.step, total_steps=20, events=events), saved


def straggler(mod):
    saved = [0]
    cfg = mod.ElasticConfig(total_hosts=4, model_parallel=2,
                            chips_per_host=4, checkpoint_every=100,
                            straggler_patience=2)
    co = mod.ElasticCoordinator(cfg, global_batch=32,
                                save_fn=lambda s: saved.append(s),
                                restore_fn=lambda: saved[-1])

    def step_fn(step, dp):
        # the slow host disappears from the fleet once evicted
        n = co.state.healthy_hosts
        times = [1.0] * n
        if co.state.evictions == 0 and step >= 5:
            times[2] = 3.0
        return times

    return co.run(step_fn, total_steps=12), saved


def scale_up(mod):
    saved = [0]
    cfg = mod.ElasticConfig(total_hosts=4, model_parallel=2,
                            chips_per_host=4)
    co = mod.ElasticCoordinator(cfg, global_batch=32,
                                save_fn=lambda s: saved.append(s),
                                restore_fn=lambda: saved[-1])
    dp0 = co.state.data_parallel
    fleet = _Fleet(6)
    events = {4: lambda c: c.on_host_join(2)}
    st = co.run(fleet.step, total_steps=8, events=events)
    assert st.data_parallel >= dp0
    return st, saved


def both(scenario):
    (jst, jsaved), (tst, tsaved) = scenario(jelastic), scenario(telastic)
    assert dataclasses.asdict(tst) == dataclasses.asdict(jst)
    assert tst.log == jst.log and tst.log
    assert tsaved == jsaved
    return tst


@pytest.mark.parametrize("chips,mp,batch", [
    (256, 16, 256), (240, 16, 256), (15, 16, 256), (28, 4, 64),
    (24, 4, 64), (512, 16, 96), (48, 2, 32), (0, 4, 8), (1024, 1, 7)])
def test_valid_data_parallel_is_the_references(chips, mp, batch):
    assert telastic.valid_data_parallel(chips, mp, batch) == \
        jelastic.valid_data_parallel(chips, mp, batch)


def test_valid_data_parallel_divisibility():
    assert telastic.valid_data_parallel(256, 16, 256) == 16
    assert telastic.valid_data_parallel(240, 16, 256) == 8
    assert telastic.valid_data_parallel(15, 16, 256) == 0


def test_elastic_failure_restores_and_reshapes():
    st = both(failure)
    assert st.step == 20
    assert st.reshapes == 1 and st.restores == 1
    assert st.healthy_hosts == 7
    assert st.data_parallel == telastic.valid_data_parallel(28, 4, 64)


def test_elastic_straggler_eviction():
    st = both(straggler)
    assert st.evictions == 1
    assert st.healthy_hosts == 3
    assert st.step == 12


def test_elastic_scale_up():
    st = both(scale_up)
    assert st.healthy_hosts == 6


def test_too_few_hosts_raise_on_both_sides():
    for mod in (jelastic, telastic):
        cfg = mod.ElasticConfig(total_hosts=2, model_parallel=8,
                                chips_per_host=4, min_data_parallel=1)
        co = mod.ElasticCoordinator(cfg, global_batch=8,
                                    save_fn=lambda s: None,
                                    restore_fn=lambda: 0)
        with pytest.raises(RuntimeError, match="not enough healthy hosts"):
            co.run(_Fleet(2).step, total_steps=4,
                   events={1: lambda c: c.on_host_failure(0)})
