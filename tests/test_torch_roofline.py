"""`repro_torch.core.roofline` and `repro_torch.core.autotune` on the CPU,
against the JAX package's modules of the same names: the analytic models
and the totals-to-roofline arithmetic equal the reference exactly for all
ten archs and four shapes and on tests/test_roofline_autotune.py's
synthetic cases; the execution points, their keys and domains, the §5.1
selection and the greedy loop (driven by one synthetic score function)
equal the reference's, round for round."""

import dataclasses
import json

import pytest

from repro import configs as ref_configs
from repro.core import autotune as ref_at
from repro.core import roofline as ref_rf
from repro_torch import configs
from repro_torch.core import autotune as at
from repro_torch.core import roofline as rf
from repro_torch.launch import dryrun

ARCHS = list(ref_configs.ARCH_NAMES)
SHAPES = [s.name for s in ref_configs.SHAPES]


def test_the_registries_list_the_same_cells():
    assert list(configs.ARCH_NAMES) == ARCHS
    assert [(a, s.name) for a, s in configs.cells()] == \
        [(a, s.name) for a, s in ref_configs.cells()]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_analytic_bytes_equal_the_reference(arch, shape):
    mine, ref = configs.get_arch(arch), ref_configs.get_arch(arch)
    s_mine = configs.shape_by_name(shape)
    s_ref = ref_configs.shape_by_name(shape)
    assert rf.model_flops(mine, s_mine) == ref_rf.model_flops(ref, s_ref)
    for chips, tp, mb, kvb in ((256, 16, 1, 2), (512, 16, 4, 1),
                               (1, 1, 1, 2), (16, 8, 2, 2)):
        assert rf.analytic_hbm_bytes(
            mine, s_mine, chips, microbatches=mb, tp=tp, kv_bytes=kvb) == \
            ref_rf.analytic_hbm_bytes(ref, s_ref, chips, microbatches=mb,
                                      tp=tp, kv_bytes=kvb)
    assert configs.cell_applicable(arch, s_mine) == \
        ref_configs.cell_applicable(arch, s_ref)


def _ref_hw_for_port():
    h = ref_rf.HW()
    return rf.HW(peak_flops=h.peak_flops, hbm_bw=h.hbm_bw, ici_bw=h.ici_bw,
                 hbm_bytes=h.hbm_bytes)


@pytest.mark.parametrize("case", [
    # tests/test_roofline_autotune.py::test_roofline_bottleneck_selection
    dict(chips=256, flops=197e12 * 0.1, hbm_bytes=819e9 * 0.5,
         coll=[("all-reduce", int(50e9))], peak_bytes=1e9,
         model_flops_total=197e12 * 0.1 * 256, analytic_bytes=0.0),
    dict(chips=1, flops=3.2e15, hbm_bytes=9e14, coll=[],
         peak_bytes=9e10, model_flops_total=1e15, analytic_bytes=2e9),
    dict(chips=16, flops=0.0, hbm_bytes=1e9,
         coll=[("all-gather", 10), ("all-to-all", 7), ("all-gather", 5)],
         peak_bytes=0.0, model_flops_total=0.0, analytic_bytes=0.0),
])
@pytest.mark.parametrize("hw", ["reference", "h100"])
def test_roofline_from_totals_equals_the_reference(case, hw):
    kw = dict(case)
    coll_mine, coll_ref = rf.CollectiveStats(), ref_rf.CollectiveStats()
    for kind, nb in kw.pop("coll"):
        coll_mine.add(kind, nb)
        coll_ref.add(kind, nb)
    if hw == "reference":
        hw_mine, hw_ref = _ref_hw_for_port(), ref_rf.HW()
    else:
        hw_mine = rf.HW()
        hw_ref = ref_rf.HW(peak_flops=hw_mine.peak_flops,
                           hbm_bw=hw_mine.hbm_bw, ici_bw=hw_mine.ici_bw,
                           hbm_bytes=hw_mine.hbm_bytes)
    mine = rf.roofline_from_totals(arch="x", shape="s", mesh_name="m",
                                   coll=coll_mine, hw=hw_mine, **kw)
    ref = ref_rf.roofline_from_totals(arch="x", shape="s", mesh_name="m",
                                      coll=coll_ref, hw=hw_ref, **kw)
    assert mine.to_json() == ref.to_json()
    assert mine.row() == ref.row()
    assert rf.RooflineReport.from_json(mine.to_json()) == mine


def test_h100_constants_are_the_datasheet_values():
    h = rf.HW()
    assert (h.peak_flops, h.hbm_bw, h.ici_bw, h.hbm_bytes, h.fp32_flops) \
        == (989e12, 3.35e12, 450e9, 80e9, 67e12)


def test_xla_readers_are_not_ported():
    for fn in (lambda: rf.parse_collective_bytes(""),
               lambda: rf.measure_compiled(None),
               lambda: rf.analyze_compiled(None)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            fn()


POINTS = [at.ExecPoint(), at.ExecPoint(microbatches=4),
          at.ExecPoint(sharding_mode="tp", remat="none", attn_kv_block=512),
          at.ExecPoint(moe_group_size=8192,
                       extra_rules=(("kv_seq", None),)),
          at.ExecPoint(extra_rules=(("mlstm_state", "model"),))]


@pytest.mark.parametrize("i", range(len(POINTS)))
def test_exec_point_key_and_overrides_equal_the_reference(i):
    mine = POINTS[i]
    ref = ref_at.ExecPoint(**dataclasses.asdict(mine))
    assert mine.key() == ref.key()
    assert mine.overrides() == ref.overrides()


@pytest.mark.parametrize("has_moe", [False, True])
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_domains_equal_the_reference(mode, has_moe):
    assert at.EXEC_DOMAINS == ref_at.EXEC_DOMAINS
    assert at._domains_for(mode, has_moe) == ref_at._domains_for(mode,
                                                                 has_moe)
    assert at.exec_space(mode, has_moe).domains == \
        at._domains_for(mode, has_moe)


@pytest.mark.parametrize("records", [
    {"p1": {"a": 1.0, "b": 1.0}, "p2": {"a": 4.0, "b": 0.25},
     "p3": {"a": 2.0, "b": 2.0}, "p4": {"a": 9.0},
     "p5": {"a": 9.0, "b": 0.0}},
    {"x": {"a": 3.0, "b": 5.0, "c": 0.5}, "y": {"a": 1.0, "b": 1.0},
     "z": {"a": 2.0, "b": 2.0, "c": 2.0}},
    {"only": {"a": 0.0}},
])
def test_select_geomean_config_equals_the_reference(records):
    assert at.select_geomean_config(records) == \
        ref_at.select_geomean_config(records)


class _Synthetic:
    """A duck-typed evaluator: a smooth score over the point's fields,
    with a 0 ("constraint violation") region."""

    def __init__(self):
        self.calls = []

    def score(self, pt) -> float:
        d = dataclasses.asdict(pt)
        self.calls.append(json.dumps(d, sort_keys=True))
        if d["attn_kv_block"] == 4096 and d["remat"] == "none":
            return 0.0
        s = 1.0 / (1 + abs(d["microbatches"] - 4))
        s *= {"fsdp": 1.0, "tp": 1.3}[d["sharding_mode"]]
        s *= {"full": 0.8, "dots": 1.1, "none": 1.2}[d["remat"]]
        s *= 1.0 + d["attn_kv_block"] / 8192
        s *= 1.0 + 0.1 * len(d["extra_rules"])
        return s


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("mode,moe", [("train", False), ("train", True),
                                      ("prefill", False)])
def test_greedy_autotune_equals_the_reference(seed, mode, moe):
    mine_ev, ref_ev = _Synthetic(), _Synthetic()
    mine_log, ref_log = [], []
    best, score = at.autotune_search(mine_ev, shape_mode=mode, has_moe=moe,
                                     seed=seed, log=mine_log,
                                     chains=3)           # dropped, as in ref
    ref_best, ref_score = ref_at.greedy_autotune(
        ref_ev, shape_mode=mode, has_moe=moe, seed=seed, log=ref_log)
    assert dataclasses.asdict(best) == dataclasses.asdict(ref_best)
    assert score == ref_score
    assert mine_log == ref_log
    assert mine_ev.calls == ref_ev.calls


@pytest.mark.parametrize("engine", ["anneal", "genetic", "random", "tpe",
                                    "nsga2"])
def test_other_engines_run_and_equal_the_reference(engine):
    """Every engine besides greedy runs through the evaluator-mode Study
    (tests/test_torch_generic.py holds more cases)."""
    mine_ev, ref_ev = _Synthetic(), _Synthetic()
    best, score = at.autotune_search(mine_ev, engine=engine, seed=0,
                                     max_rounds=3)
    ref_best, ref_score = ref_at.autotune_search(ref_ev, engine=engine,
                                                 seed=0, max_rounds=3)
    assert dataclasses.asdict(best) == dataclasses.asdict(ref_best)
    assert score == ref_score > 0
    assert mine_ev.calls == ref_ev.calls


@pytest.fixture
def smoke_registry(monkeypatch):
    """`run_cell` on the smoke configs (same families, small widths)."""
    monkeypatch.setattr(dryrun.configs, "get_arch", configs.get_smoke)


def test_cell_evaluator_scores_the_dry_run_and_memoizes(tmp_path,
                                                        smoke_registry):
    ev = at.CellEvaluator("qwen2-0.5b", "decode_32k", cache_dir=tmp_path,
                          device="cpu")
    assert ev.hbm_limit == rf.HW().hbm_bytes == 80e9
    assert ev.cell == "qwen2-0.5b_decode_32k_1gpu"
    pt = at.ExecPoint(sharding_mode="tp", remat="none")
    s = ev.score(pt)
    rec = ev.evaluate(pt)                       # from the disk cache
    assert ev.n_compiles == 1
    assert rec["point"] == json.loads(json.dumps(dataclasses.asdict(pt)))
    assert s == 1.0 / rec["roofline"]["roofline_s"] > 0
    tight = at.CellEvaluator("qwen2-0.5b", "decode_32k", cache_dir=tmp_path,
                             device="cpu",
                             hbm_limit=rec["roofline"]["peak_memory_per_chip"]
                             - 1)
    assert tight.score(pt) == 0.0               # over the limit: 0 GOPS
    assert tight.n_compiles == 0                # memoized on disk


def test_cell_evaluator_shares_one_dry_run_between_points_of_one_step(
        tmp_path, smoke_registry):
    """On one GPU only `overrides()` change the step: points that differ in
    sharding, remat, microbatches or layout rules cost one dry-run."""
    ev = at.CellEvaluator("qwen2-0.5b", "decode_32k", cache_dir=tmp_path,
                          device="cpu")
    inert = [at.ExecPoint(),
             at.ExecPoint(sharding_mode="tp", remat="none"),
             at.ExecPoint(microbatches=4,
                          extra_rules=(("kv_seq", None),))]
    scores = [ev.score(pt) for pt in inert]
    assert ev.n_compiles == 1
    assert scores[0] > 0 and scores == [scores[0]] * 3
    for pt in inert:
        assert ev.evaluate(pt)["point"] == json.loads(
            json.dumps(dataclasses.asdict(pt)))
    assert ev.score(at.ExecPoint(attn_kv_block=512)) > 0
    assert ev.n_compiles == 2


def test_greedy_autotune_over_a_dry_run_returns_a_scored_point(
        tmp_path, smoke_registry):
    ev = at.CellEvaluator("recurrentgemma-9b", "decode_32k",
                          cache_dir=tmp_path, device="cpu")
    log = []
    best, score = at.autotune_search(ev, shape_mode="decode", seed=0,
                                     max_rounds=3, log=log)
    assert score == ev.score(best) > 0
    assert log[0]["event"] == "init"
    for r in log[1:]:
        assert r["var"] in at._domains_for("decode", False)
        assert all(s > 0 for s in r["scores"])
