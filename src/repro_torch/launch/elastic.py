"""Elastic / fault-tolerant training coordinator: the twin of
`repro.launch.elastic` (numpy only).

On a real cluster each host runs this loop around `train.py`; here the
failure and straggler signals are injectable so the whole state machine is
exercisable on CPU (tests/test_torch_elastic.py) — the logic is the
deliverable, the transport (GCS + coordination service) is environment
plumbing.

State machine per "incident":

  RUNNING --(node failure detected)--> RESHAPE:
      pick the largest valid mesh from the survivors (data axis shrinks;
      the model axis is never broken — TP groups live inside a pod),
      restore the latest checkpoint, rewind the data iterator to the
      checkpoint step (step-keyed pipeline => no data loss), resume.
  RUNNING --(straggler detected)--> MITIGATE:
      a host whose step time exceeds `straggler_factor` x the fleet median
      for `straggler_patience` consecutive steps is marked suspect; it is
      evicted exactly like a failure (checkpoint-restore-reshape) — with
      synchronous collectives, one slow host rate-limits the whole fleet,
      so eviction beats waiting.
  RUNNING --(scale-up event)--> GROW: same reshape path, data axis grows.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

__all__ = ["ElasticConfig", "ElasticState", "ElasticCoordinator",
           "valid_data_parallel"]


@dataclasses.dataclass
class ElasticConfig:
    total_hosts: int
    model_parallel: int = 16          # chips on the model axis (unbroken)
    chips_per_host: int = 4
    checkpoint_every: int = 50
    straggler_factor: float = 2.0
    straggler_patience: int = 3
    min_data_parallel: int = 1


def valid_data_parallel(healthy_chips: int, model_parallel: int,
                        global_batch: int) -> int:
    """Largest data-parallel degree that divides the batch and fits the
    surviving chips (model axis fixed)."""
    dp = healthy_chips // model_parallel
    while dp > 0 and global_batch % dp != 0:
        dp -= 1
    return dp


@dataclasses.dataclass
class ElasticState:
    step: int = 0
    data_parallel: int = 0
    healthy_hosts: int = 0
    reshapes: int = 0
    evictions: int = 0
    restores: int = 0
    log: List[str] = dataclasses.field(default_factory=list)


class ElasticCoordinator:
    """Drives a step function with failure/straggler handling.

    `step_fn(step, data_parallel) -> step_time_per_host`: in production the
    pjit'd train step; in tests a stub that returns simulated per-host step
    times (and raises `HostFailure` for hard faults).
    """

    def __init__(self, cfg: ElasticConfig, global_batch: int,
                 save_fn: Callable[[int], None],
                 restore_fn: Callable[[], int]):
        self.cfg = cfg
        self.global_batch = global_batch
        self.save_fn = save_fn
        self.restore_fn = restore_fn
        self.state = ElasticState(
            healthy_hosts=cfg.total_hosts,
            data_parallel=valid_data_parallel(
                cfg.total_hosts * cfg.chips_per_host, cfg.model_parallel,
                global_batch))
        self._slow_counts: Dict[int, int] = {}

    # ------------------------------------------------------------ incidents
    def _reshape(self, reason: str) -> None:
        st, cfg = self.state, self.cfg
        chips = st.healthy_hosts * cfg.chips_per_host
        dp = valid_data_parallel(chips, cfg.model_parallel,
                                 self.global_batch)
        if dp < cfg.min_data_parallel:
            raise RuntimeError(
                f"not enough healthy hosts to continue ({st.healthy_hosts})")
        st.data_parallel = dp
        st.reshapes += 1
        st.step = self.restore_fn()       # rewind to the last checkpoint
        st.restores += 1
        st.log.append(f"step={st.step} reshape({reason}): "
                      f"hosts={st.healthy_hosts} dp={dp}")

    def on_host_failure(self, host: int) -> None:
        self.state.healthy_hosts -= 1
        self.state.log.append(f"step={self.state.step} host{host} FAILED")
        self._reshape(f"host{host} failure")

    def on_host_join(self, n: int = 1) -> None:
        self.state.healthy_hosts += n
        self._reshape(f"+{n} hosts joined")

    def _check_stragglers(self, times: Sequence[float]) -> Optional[int]:
        med = float(np.median(times))
        for host, t in enumerate(times):
            if t > self.cfg.straggler_factor * med:
                self._slow_counts[host] = self._slow_counts.get(host, 0) + 1
                if self._slow_counts[host] >= self.cfg.straggler_patience:
                    return host
            else:
                self._slow_counts[host] = 0
        return None

    # ------------------------------------------------------------ main loop
    def run(self, step_fn, total_steps: int,
            events: Optional[Dict[int, Callable[["ElasticCoordinator"],
                                                None]]] = None
            ) -> ElasticState:
        st = self.state
        events = events or {}
        while st.step < total_steps:
            if st.step in events:
                ev = events.pop(st.step)
                ev(self)
                continue
            times = step_fn(st.step, st.data_parallel)
            slow = self._check_stragglers(times)
            if slow is not None:
                st.healthy_hosts -= 1
                st.evictions += 1
                st.log.append(f"step={st.step} host{slow} evicted "
                              f"(straggler)")
                self._slow_counts.clear()
                self._reshape(f"host{slow} straggler eviction")
                continue
            st.step += 1
            if st.step % self.cfg.checkpoint_every == 0:
                self.save_fn(st.step)
        return st
