"""The dry-run over a mesh (`launch.steps.trace_step(mesh=...)`,
`launch.dryrun.run_cell(multi_pod=...)`, `core.roofline.
parse_collective_bytes`, the mesh-aware `core.autotune.CellEvaluator`)
against the JAX package's, on the CPU.

The port's steps run on DTensors over a fake process group made in this
process (`tests/_fake_group.py`: rank 0 of 8, or `dryrun.fake_mesh`'s 256
/ 512 ranks), its model code laying out activations at the reference's
`rt.shard` sites, and are counted per rank.  The reference is compiled by
XLA on 8 forced host devices, in subprocesses (jax fixes its device count
at start-up), on the same (2, 4) mesh on ("data", "model"):
`build_step_bundle` -> `compile` -> `memory_analysis()` /
`cost_analysis()` / `as_text()`.

What is held, and the differences that are counted, not waved through:

* On a (1, 1) mesh every smoke cell's per-rank counts equal the unplaced
  step's exactly, with no collective.  The serving steps run under
  `no_grad` over a mesh (`inference_mode` cannot take DTensor views), and
  ATen decomposes a few ops otherwise under `no_grad`: `matmul` takes a
  decode step's `[B, 1, d]` activation (whose size-1 dimension has a
  non-contiguous stride) through `expand` + `bmm`, not `view` + `mm` (more
  operand bytes: the expanded weight), and `torch.tensor` of a constant
  (recurrentgemma's embedding scale) takes no `detach_`.  So a serving
  step is held exactly to the unplaced step under `no_grad`, and to the
  one under `inference_mode` in its FLOPs and peak.
* On the (2, 4) mesh the per-rank bytes of every argument equal the
  reference's `argument_size_in_bytes` less the integer inputs' width: the
  reference's `tokens`, `token` and `pos` are int32, the port's int64 (4
  bytes more a local element).  xlstm-1.3b's decode has no use for `pos`
  (its state has no positions), and XLA drops the unused parameter: 4
  bytes more.  whisper-medium's decode reads neither the encoder's
  parameters nor its cross-attention's k and v projections (made and
  dropped, as in the reference), and XLA drops those too.
* The per-rank FLOPs of a prefill lie between the unplaced step's share
  (its count over the 8 ranks) and XLA's per-partition count: every rank
  computes what is replicated (RoPE's tables, masks, norms' statistics),
  and XLA's partitioner undoes the attention's sequence split (it reports
  an involuntary full rematerialization) and computes more of the
  attention on each device, where the port attends each rank's rows of q
  (`layers._attention_on_local_rows`).  `tests/test_torch_flops.py`
  holds the unplaced count to XLA's at its tolerances.
* Collectives: `swiglu` alone has XLA's collectives, kind for kind and
  count for count, at half the bytes: XLA:CPU widens a bf16 product's
  operands to fp32 before the product, so it gathers the weights and
  reduces the partial products in fp32, the port in bf16.  The GQA block
  differs in kind: XLA's reshards of its rematerialized attention are
  all-to-alls and collective-permutes; the port only gathers (k and v
  within the batch shard, the output projection's weight, the output's
  rows), far fewer bytes.
* A decode's attention over a cache split on its sequence (whisper-
  medium's self-attention under `kv_seq`): XLA all-to-alls each rank's k
  and v to a split of the KV heads and attends its heads over the whole
  sequence, and so does the port, at half XLA:CPU's fp32 bytes; on the
  CPU's fake group DTensor runs the all-to-all as an all-gather and a
  chunk (`_dtensor.shard_dim_alltoall`'s CPU fallback), so the gather
  moves the split's size times the bytes.
"""

import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from _fake_group import fake_world
from repro.core import roofline as ref_rf
from repro.launch import mesh as ref_mesh
from repro_torch import configs as tconfigs
from repro_torch.configs.shapes import ShapeSpec, shape_by_name
from repro_torch.core import autotune as at
from repro_torch.core import roofline as rf
from repro_torch.distributed import shard_shape
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import layers as L

SRC = str(Path(__file__).resolve().parents[1] / "src")
ARCHS = list(tconfigs.ARCH_NAMES)
MODES = ("train", "prefill", "decode")


def smoke_shape(mode):
    return ShapeSpec(f"smoke_{mode}", 64, 8, mode)


def micro(mode):
    return 2 if mode == "train" else 1


def cells():
    return [(a, m) for a in ARCHS for m in MODES]


@pytest.fixture
def mesh2x4():
    with fake_world(8):
        yield make_mesh((2, 4), ("data", "model"), "cpu")


@pytest.fixture
def mesh1x1():
    with fake_world(8):
        yield make_mesh((1, 1), ("data", "model"), "cpu")


def _same(a: steps.StepCounts, b: steps.StepCounts):
    assert (a.flops, a.matmul_flops, a.elementwise_flops,
            a.transcendentals, a.peak_bytes, a.ops, a.bytes_accessed) == \
        (b.flops, b.matmul_flops, b.elementwise_flops, b.transcendentals,
         b.peak_bytes, b.ops, b.bytes_accessed)


# ------------------------------------------------------- (a) a (1, 1) mesh

ONE_RANK = cells()


@pytest.mark.parametrize("arch,mode", ONE_RANK,
                         ids=["-".join(c) for c in ONE_RANK])
def test_one_rank_mesh_counts_equal_the_unplaced_counts(arch, mode, mesh1x1,
                                                        monkeypatch):
    cfg, shape = tconfigs.get_smoke(arch), smoke_shape(mode)
    placed, _ = steps.trace_step(cfg, shape, device="cpu", mesh=mesh1x1,
                                 microbatches=micro(mode))
    assert placed.collectives.count == 0 == placed.collectives.total_bytes
    plain, _ = steps.trace_step(cfg, shape, device="cpu",
                                microbatches=micro(mode))
    assert placed.arg_bytes == plain.arg_bytes
    if mode == "train":
        _same(placed, plain)
        assert placed.flops_by_op == plain.flops_by_op
        return
    # the serving step over a mesh runs under no_grad (module docstring)
    assert (placed.flops, placed.transcendentals, placed.peak_bytes) == \
        (plain.flops, plain.transcendentals, plain.peak_bytes)
    monkeypatch.setattr(steps, "_no_autograd", lambda p: torch.no_grad())
    plain_no_grad, _ = steps.trace_step(cfg, shape, device="cpu")
    _same(placed, plain_no_grad)
    assert placed.flops_by_op == plain_no_grad.flops_by_op


# -------------------------------------------- the reference, compiled by XLA

REF_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, json, sys
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding
    from repro import configs
    from repro.configs.shapes import ShapeSpec
    from repro.core.roofline import parse_collective_bytes
    from repro.launch.mesh import make_mesh
    from repro.launch.steps import build_step_bundle, make_runtime
    from repro.models import layers as L

    mesh = make_mesh((2, 4), ("data", "model"))
    out = {}
    for job in json.loads(sys.argv[1]):
        arch = configs.get_smoke(job["arch"])
        if job.get("layers"):
            arch = dataclasses.replace(arch, num_layers=job["layers"])
        shape = ShapeSpec("x", job["seq"], job["batch"], job["mode"])
        if job["kind"] == "cell":
            ov = dict(job.get("overrides") or {})
            if "compute_dtype" in ov:
                ov["compute_dtype"] = getattr(jnp, ov["compute_dtype"])
            b = build_step_bundle(arch, shape, mesh, sharding_mode=job["sm"],
                                  microbatches=job["micro"], overrides=ov)
            with mesh:
                c = b.lower().compile()
            ca = c.cost_analysis()
            ca = ca[0] if isinstance(ca, (list, tuple)) else ca
            rec = {"args": c.memory_analysis().argument_size_in_bytes,
                   "flops": ca.get("flops"),
                   "trans": ca.get("transcendentals")}
            if job.get("hlo"):
                rec["hlo"] = c.as_text()
            if job.get("coll"):
                rec["coll"] = parse_collective_bytes(c.as_text()).by_kind
        else:
            rt = make_runtime(mesh, arch, shape, sharding_mode=job["sm"])
            d, hd = arch.d_model, arch.resolved_head_dim
            if job["kind"] == "swiglu":
                specs = L.swiglu_specs(d, arch.d_ff)
                fn = lambda p, x: L.swiglu(p, x, rt)
            else:
                specs = L.gqa_specs(d, arch.num_heads, arch.num_kv_heads, hd,
                                    arch.qkv_bias)
                fn = lambda p, x: L.gqa_attention_train(
                    p, x, n_heads=arch.num_heads, n_kv=arch.num_kv_heads,
                    hd=hd, rope_theta=arch.rope_theta, rt=rt)
            p = {k: jax.ShapeDtypeStruct(s.shape, jnp.bfloat16)
                 for k, s in specs.items()}
            p_sh = {k: NamedSharding(mesh, rt.rules.spec(list(s.axes)))
                    for k, s in specs.items()}
            x = jax.ShapeDtypeStruct((shape.global_batch, shape.seq_len, d),
                                     jnp.bfloat16)
            x_sh = NamedSharding(mesh, rt.rules.spec(["batch", None, None]))
            with mesh:
                c = jax.jit(fn, in_shardings=(p_sh, x_sh),
                            out_shardings=x_sh).lower(p, x).compile()
            coll = parse_collective_bytes(c.as_text())
            rec = {"coll": coll.by_kind, "n": coll.count,
                   "flops": c.cost_analysis()["flops"]}
        out[job["key"]] = rec
    print("RESULT " + json.dumps(out))
""")

# (arch, layers, compute dtype): the prefills `test_torch_flops.py` holds
# to XLA on one device, at its shapes (2 x 32 tokens, KV tile 32)
FLOP_CELLS = [("qwen2-0.5b", 1, "bfloat16"), ("qwen2-0.5b", 1, "float32"),
              ("recurrentgemma-9b", 3, "float32")]


def _jobs():
    jobs = []
    for arch, mode in cells():
        for sm in (("fsdp", "tp") if mode != "decode" else ("tp",)):
            jobs.append({"kind": "cell", "key": f"{arch}/{mode}/{sm}",
                         "arch": arch, "mode": mode, "sm": sm, "seq": 64,
                         "batch": 8, "micro": micro(mode),
                         "hlo": arch == "qwen2-0.5b",
                         "coll": (arch, mode) == ("whisper-medium",
                                                  "decode")})
    for arch, layers, dt in FLOP_CELLS:
        for sm in ("fsdp", "tp"):
            jobs.append({"kind": "cell", "key": f"flops/{arch}/{dt}/{sm}",
                         "arch": arch, "layers": layers, "mode": "prefill",
                         "sm": sm, "seq": 32, "batch": 2, "micro": 1,
                         "overrides": {"attn_kv_block": 32,
                                       "compute_dtype": dt}})
    for kind in ("swiglu", "gqa"):
        for sm in ("fsdp", "tp"):
            jobs.append({"kind": kind, "key": f"{kind}/{sm}",
                         "arch": "qwen2-0.5b", "mode": "prefill", "sm": sm,
                         "seq": 64, "batch": 8})
    return jobs


@pytest.fixture(scope="module")
def ref():
    """Every job compiled by XLA, in 6 subprocesses at once (each with 8
    forced host devices)."""
    jobs = _jobs()
    groups = [jobs[i::6] for i in range(6)]
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)

    def run(group):
        proc = subprocess.run(
            [sys.executable, "-c", REF_SCRIPT, json.dumps(group)], env=env,
            capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("RESULT ")][-1]
        return json.loads(line.split(" ", 1)[1])

    out = {}
    with concurrent.futures.ThreadPoolExecutor(len(groups)) as pool:
        for res in pool.map(run, groups):
            out.update(res)
    return out


# ------------------------------------------ (b) argument bytes, FLOPs on 2x4

def _int_width(arch, mode):
    """The int64 inputs' extra bytes over the reference's int32 ones: 4 a
    local element of `tokens`, `token` (their batch on "data", 2) and
    `pos` (replicated)."""
    specs = steps.input_specs(tconfigs.get_smoke(arch), smoke_shape(mode))
    return sum(4 * (torch.Size(shp).numel() // (2 if shp else 1))
               for shp, dt in specs.values() if dt == torch.int64)


@pytest.mark.parametrize("key", [j["key"] for j in _jobs()
                                 if j["kind"] == "cell"
                                 and not j["key"].startswith("flops/")])
def test_per_rank_argument_bytes_equal_the_references(key, ref, mesh2x4):
    arch, mode, sm = key.split("/")
    counts, _ = steps.trace_step(tconfigs.get_smoke(arch), smoke_shape(mode),
                                 device="cpu", mesh=mesh2x4, sharding_mode=sm,
                                 microbatches=micro(mode))
    mine = sum(counts.arg_bytes.values())
    want = ref[key]["args"] + _int_width(arch, mode)
    if (arch, mode) == ("xlstm-1.3b", "decode"):
        want += 4                      # XLA drops the unused int32 `pos`
    if (arch, mode) == ("whisper-medium", "decode"):
        want += _unread_by_the_decode(mesh2x4)
    assert mine == want
    # each rank's params are the sum of their leaves' shard shapes
    lay = steps.step_placements(tconfigs.get_smoke(arch), smoke_shape(mode),
                                mesh2x4, sharding_mode=sm).inputs[0]
    dt = torch.float32 if mode == "train" else torch.bfloat16
    model = steps.build_model(tconfigs.get_smoke(arch))
    want_params = sum(
        torch.Size(shard_shape(lo.shape, mesh2x4, lo.placements)).numel()
        * torch.empty((), dtype=s.resolved_dtype(dt)).element_size()
        for lo, s in zip(_leaves(lay), _leaves(model.param_specs())))
    assert counts.arg_bytes["params"] == want_params
    assert counts.collectives.total_bytes > 0


def _unread_by_the_decode(mesh) -> int:
    """Per-rank bytes of whisper-medium's parameters its decode step never
    reads, which XLA drops from the compiled step's arguments (`jax.jit`
    keeps no unused argument): the encoder's, and each decoder layer's
    cross-attention k and v projections, made and dropped as in the
    reference (its cross caches are inputs)."""
    from torch.utils import _pytree as pytree

    cfg = tconfigs.get_smoke("whisper-medium")
    lay = steps.step_placements(cfg, smoke_shape("decode"), mesh).inputs[0]
    unread = 0
    for path, lo in pytree.tree_flatten_with_path(
            lay, is_leaf=lambda x: hasattr(x, "placements"))[0]:
        name = pytree.keystr(path)
        if name.startswith("['enc") or "['xattn']" in name and \
                name.endswith(("['wk']", "['wv']", "['bk']", "['bv']")):
            unread += torch.Size(shard_shape(lo.shape, mesh, lo.placements)
                                 ).numel() * 2
    return unread


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


@pytest.mark.parametrize("arch,layers,dt", FLOP_CELLS, ids=str)
@pytest.mark.parametrize("sm", ["fsdp", "tp"])
def test_per_rank_prefill_flops_lie_between_the_share_and_xla(
        arch, layers, dt, sm, ref, mesh2x4):
    cfg = dataclasses.replace(tconfigs.get_smoke(arch), num_layers=layers)
    shape = ShapeSpec("x", 32, 2, "prefill")
    ov = {"attn_kv_block": 32, "compute_dtype": getattr(torch, dt)}
    rank, _ = steps.trace_step(cfg, shape, device="cpu", mesh=mesh2x4,
                               sharding_mode=sm, overrides=ov)
    whole, _ = steps.trace_step(cfg, shape, device="cpu", overrides=ov)
    xla = ref[f"flops/{arch}/{dt}/{sm}"]
    assert whole.flops / 8 <= rank.flops <= xla["flops"]
    assert whole.transcendentals / 8 <= rank.transcendentals \
        <= xla["trans"]


# --------------------------------------- (c) collectives of two blocks alone

def _block_counts(kind, sm, mesh):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed import logical_placements

    cfg = tconfigs.get_smoke("qwen2-0.5b")
    rt = steps.make_runtime(cfg, smoke_shape("prefill"), mesh=mesh,
                            sharding_mode=sm)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    if kind == "swiglu":
        specs = L.swiglu_specs(d, cfg.d_ff)

        def fn(p, x):
            return L.swiglu(p, x, rt)
    else:
        specs = L.gqa_specs(d, cfg.num_heads, cfg.num_kv_heads, hd,
                            cfg.qkv_bias)

        def fn(p, x):
            return L.gqa_attention_train(
                p, x, n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads, hd=hd,
                rope_theta=cfg.rope_theta, rt=rt)

    def place(shape, axes):
        return distribute_tensor(torch.empty(shape, dtype=torch.bfloat16),
                                 mesh, logical_placements(mesh, rt.rules,
                                                          axes))

    with FakeTensorMode(), implicit_replication():
        p = {k: place(s.shape, s.axes) for k, s in specs.items()}
        x = place((8, 64, d), ["batch", None, None])
        # out as in: the reference's `out_shardings`
        return steps.count_step(
            lambda p, x: rt.shard(fn(p, x), "batch", None, None), p, x)[1]


@pytest.mark.parametrize("sm", ["fsdp", "tp"])
def test_swiglu_collectives_are_xlas_in_bf16(sm, ref, mesh2x4):
    mine = _block_counts("swiglu", sm, mesh2x4).collectives
    xla = ref[f"swiglu/{sm}"]
    assert mine.count == xla["n"]
    # XLA:CPU gathers and reduces the fp32-widened operands (docstring)
    assert {k: 2 * b for k, b in mine.by_kind.items()} == xla["coll"]


@pytest.mark.parametrize("sm", ["fsdp", "tp"])
def test_gqa_collectives_differ_from_xlas_by_its_reshards(sm, ref, mesh2x4):
    mine = _block_counts("gqa", sm, mesh2x4).collectives
    xla = ref[f"gqa/{sm}"]
    # the port: gathers only (on the CPU group DTensor's all-to-all is an
    # all-gather, see `_dtensor.shard_dim_alltoall`): k and v within the
    # batch shard, the output projection's weight (`layers.project_rows`:
    # each rank's rows against the whole of wo) and the output's rows at
    # the block's end; XLA: its rematerialized attention's all-to-alls and
    # collective-permutes
    assert set(mine.by_kind) == {"all-gather"}
    assert {"all-to-all", "collective-permute"} <= set(xla["coll"])
    assert mine.total_bytes < sum(xla["coll"].values())


# -------------------------------------- (d) the rules move the per-rank bytes

def test_sharding_mode_and_extra_rules_move_per_rank_bytes(mesh2x4):
    cfg = tconfigs.get_smoke("qwen2-0.5b")
    train = smoke_shape("train")
    by_mode = {sm: steps.trace_step(cfg, train, device="cpu", mesh=mesh2x4,
                                    sharding_mode=sm, microbatches=2)[0]
               for sm in ("fsdp", "tp")}
    # fsdp splits every "embed" dimension over "data" (2): each leaf with
    # one holds half its tp bytes there
    model = steps.build_model(cfg)
    embed = sum(torch.Size(s.shape).numel() * 4
                for s in _leaves(model.param_specs()) if "embed" in s.axes)
    lay = steps.step_placements(cfg, train, mesh2x4,
                                sharding_mode="tp").inputs[0]
    embed_tp = sum(
        torch.Size(shard_shape(lo.shape, mesh2x4, lo.placements)).numel() * 4
        for lo, s in zip(_leaves(lay), _leaves(model.param_specs()))
        if "embed" in s.axes)
    assert embed_tp < embed
    assert by_mode["tp"].arg_bytes["params"] - \
        by_mode["fsdp"].arg_bytes["params"] == embed_tp // 2
    # decode: the KV cache's sequence on "model" (4) or not split
    dec = smoke_shape("decode")
    split, whole = (steps.trace_step(cfg, dec, device="cpu", mesh=mesh2x4,
                                     rule_updates=ru)[0]
                    for ru in (None, {"kv_seq": None}))
    assert whole.arg_bytes["cache"] == 4 * split.arg_bytes["cache"]
    assert whole.arg_bytes["params"] == split.arg_bytes["params"]


def test_autotune_sharding_mode_and_extra_rules_move_a_mesh_score(
        tmp_path, monkeypatch):
    # decode: the cache's sequence split over "model" or not moves each
    # rank's peak (the analytic memory term, the roofline's bound here,
    # does not see the layout): on a card of 1 GB only the split fits
    ev = at.CellEvaluator("qwen2-0.5b", "decode_32k", cache_dir=tmp_path,
                          device="cpu", multi_pod=False, hbm_limit=1e9)
    assert ev.cell == "qwen2-0.5b_decode_32k_16x16"
    base = at.ExecPoint(sharding_mode="tp", remat="none")
    flip = dataclasses.replace(base, extra_rules=(("kv_seq", None),))
    recs = [ev.evaluate(p) for p in (base, flip)]
    assert ev.n_compiles == 2
    peaks = [r["roofline"]["peak_memory_per_chip"] for r in recs]
    assert peaks[0] < 1e9 < peaks[1]
    assert ev.score(base) > 0 == ev.score(flip)
    # the smoke model at the cell's full shape (a few layers of fake work)
    monkeypatch.setattr(tconfigs, "get_arch", tconfigs.get_smoke)
    tev = at.CellEvaluator("qwen2-0.5b", "prefill_32k", cache_dir=tmp_path,
                           device="cpu", multi_pod=False)
    fsdp, tp = (tev.evaluate(at.ExecPoint(sharding_mode=sm, remat="none"))
                for sm in ("fsdp", "tp"))
    assert tev.n_compiles == 2
    assert fsdp["arg_bytes_per_chip"]["params"] < \
        tp["arg_bytes_per_chip"]["params"]
    assert fsdp["roofline"]["collective_bytes_per_chip"] != \
        tp["roofline"]["collective_bytes_per_chip"]
    assert tev.score(at.ExecPoint(sharding_mode="fsdp", remat="none")) != \
        tev.score(at.ExecPoint(sharding_mode="tp", remat="none"))


# ------------------------------------------------ (e) the microbatch cut

@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16",
                                                          "2x16x16"])
def test_microbatch_cut_is_the_references(multi_pod):
    shape = shape_by_name("train_4k")
    dims = ((2, 16, 16), ("pod", "data", "model")) if multi_pod else \
        ((16, 16), ("data", "model"))
    amesh = AbstractMesh(*dims)
    with dryrun.fake_mesh(multi_pod, "cpu") as mesh:
        for arch in ARCHS:
            mb = dryrun.DEFAULT_MICROBATCHES.get(arch, 1)
            for asked in (mb, 64, 1):
                # the reference's cut, `repro/launch/dryrun.py` run_cell
                n_shards = 1
                for a in ref_mesh.batch_axes_for(amesh, shape.global_batch):
                    n_shards *= amesh.shape[a]
                want = max(1, min(asked, shape.global_batch // n_shards))
                assert dryrun.cut_microbatches(mesh, shape, asked) == want
    assert dryrun.cut_microbatches(None, shape, 512) == 256


# ------------------------------------------------ (f) the HLO parser

def test_collective_parser_equals_the_references(ref):
    texts = [r["hlo"] for r in ref.values() if "hlo" in r]
    assert len(texts) == 5
    texts.append(textwrap.dedent("""
        %ag-start = (bf16[4,8]{1,0}, bf16[16,8]{1,0}) all-gather-start(bf16[4,8]{1,0} %p), dimensions={0}
        %ag-done = bf16[16,8]{1,0} all-gather-done((bf16[4,8]{1,0}, bf16[16,8]{1,0}) %ag-start)
        %ar-start = f32[128]{0} all-reduce-start(f32[128]{0} %q), to_apply=%add
        %ar-done = f32[128]{0} all-reduce-done(f32[128]{0} %ar-start)
        ROOT %cp = s32[2,2]{1,0} collective-permute(s32[2,2]{1,0} %r), source_target_pairs={{0,1}}
        %a2a = (f8e4m3fn[8]{0}, u8[8]{0}) all-to-all(f8e4m3fn[8]{0} %s, u8[8]{0} %t)
        %rs = pred[3]{0} reduce-scatter(pred[12]{0} %u), dimensions={0}
    """))
    for text in texts:
        mine, want = rf.parse_collective_bytes(text), \
            ref_rf.parse_collective_bytes(text)
        assert (mine.total_bytes, mine.by_kind, mine.count) == \
            (want.total_bytes, want.by_kind, want.count)
        assert mine.count > 0
    pairs = rf.parse_collective_bytes(texts[-1])
    assert pairs.by_kind == {"all-gather": 64 + 256, "all-reduce": 512,
                             "collective-permute": 16, "all-to-all": 16,
                             "reduce-scatter": 3}


# ------------------------------------------------ (g) the pool's scores

def test_score_batch_returns_the_serial_scores_in_pool_order(tmp_path):
    # a mesh cell: each spawned worker makes its own fake group of 256
    base = at.ExecPoint(sharding_mode="tp", remat="none")
    pts = [dataclasses.replace(base, extra_rules=r)
           for r in ((("kv_seq", None),), (), (("mlstm_state", "model"),))]
    pts.append(pts[0])
    # on a card of 1 GB the cache whole on each rank does not fit: its
    # points score 0, the others not
    pool = at.CellEvaluator("qwen2-0.5b", "decode_32k", tmp_path / "pool",
                            device="cpu", multi_pod=False, hbm_limit=1e9,
                            compile_workers=3)
    serial = at.CellEvaluator("qwen2-0.5b", "decode_32k",
                              tmp_path / "serial", device="cpu",
                              multi_pod=False, hbm_limit=1e9)
    got = pool.score_batch(pts)
    assert pool.n_compiles == 3
    assert got == [serial.score(p) for p in pts]
    assert len(set(got)) > 1


# ------------------------------------------------ (h) a mesh cell's record

def test_mesh_run_cell_record_carries_the_references_keys(tmp_path,
                                                         monkeypatch):
    # the smoke model at train_4k's batch, its sequence cut to 64
    monkeypatch.setattr(tconfigs, "get_arch", tconfigs.get_smoke)
    monkeypatch.setattr(dryrun, "shape_by_name", lambda name: ShapeSpec(
        name, 64, shape_by_name(name).global_batch,
        shape_by_name(name).mode))
    rec = dryrun.run_cell("qwen2-0.5b", "train_4k", tmp_path,
                          multi_pod=False, device="cpu")
    assert rec["status"] == "OK", rec.get("error")
    assert rec["cell"] == "qwen2-0.5b_train_4k_16x16"
    assert {"cell", "status", "lower_s", "compile_s", "total_s",
            "memory_analysis", "fits_hbm", "roofline", "probes",
            "config"} <= set(rec)
    roof = rec["roofline"]
    assert set(roof) == {f.name for f in
                         dataclasses.fields(ref_rf.RooflineReport)}
    assert (roof["chips"], roof["mesh"], rec["chips"]) == (256, "16x16",
                                                           256)
    assert roof["collective_bytes_per_chip"] > 0
    assert roof["collective_detail"] == rec["collectives"]["by_kind"]
    assert rec["config"]["microbatches"] == 2
    assert json.loads((tmp_path / f"{rec['cell']}.json").read_text()) == rec
    two_pods = dryrun.run_cell("qwen2-0.5b", "decode_32k", tmp_path,
                               multi_pod=True, device="cpu")
    assert two_pods["cell"] == "qwen2-0.5b_decode_32k_2x16x16"
    assert two_pods["chips"] == two_pods["roofline"]["chips"] == 512
    # a group left initialised is refused, not shared
    with fake_world(8):
        with pytest.raises(RuntimeError, match="initialised"):
            dryrun.run_cell("qwen2-0.5b", "decode_32k", tmp_path,
                            multi_pod=False, device="cpu")


# ------------------------------------ (i) attention over a split sequence

def test_a_sequence_split_caches_attention_reshards_as_xlas(ref, mesh2x4,
                                                           monkeypatch):
    """whisper-medium's smoke decode at 8 x 64 on the (2, 4) mesh: each
    decoder layer's self-attention reshards its rank's k and v (batch 4,
    sequence 16 of 64, 4 KV heads of 16, bf16) from the sequence to the
    KV heads, the all-to-all XLA runs in the layer body (32,768 bytes of
    fp32 operands there, measured), at half its bytes; on this CPU group
    as the all-gather of the 4 "model" shards it falls back to."""
    cfg, shape = tconfigs.get_smoke("whisper-medium"), smoke_shape("decode")
    xla = ref["whisper-medium/decode/tp"]["coll"]
    assert xla["all-to-all"] == 32768           # one layer body
    # the caches stack the layers: a layer's local k and v, bf16
    lay = steps.step_placements(cfg, shape, mesh2x4).inputs[1]
    local_kv = sum(torch.Size(shard_shape(lay[t].shape, mesh2x4,
                                          lay[t].placements)).numel() * 2
                   for t in ("k", "v")) // cfg.num_layers
    assert local_kv == xla["all-to-all"] // 2 == 16384
    reshards, attend = [], L._attention_on_local_rows

    def seen(fn, q, k, v, q_offset):
        coll = L.STEP_COUNTERS[-1].collectives
        was = dict(coll.by_kind)
        out = attend(fn, q, k, v, q_offset)
        if L.shard_count(k, 1) > 1:
            reshards.append({kind: b - was.get(kind, 0)
                             for kind, b in coll.by_kind.items()
                             if b != was.get(kind, 0)})
        return out
    monkeypatch.setattr(L, "_attention_on_local_rows", seen)
    steps.trace_step(cfg, shape, device="cpu", mesh=mesh2x4,
                     sharding_mode="tp")
    assert len(reshards) == cfg.num_layers
    for moved in reshards:
        assert moved in ({"all-to-all": local_kv},
                         {"all-gather": 4 * local_kv})


def test_a_layer_scan_on_the_mesh_counts_as_the_whole_loop(mesh2x4,
                                                          monkeypatch):
    """whisper-medium's smoke decode at six layers on the (2, 4) mesh: its
    scan over the layers runs four steps and counts one for the middle
    ones, the caches' slices written in place and returned whole
    (`layers.slice_of` on the local shards), and every per-rank count
    and collective equals the whole loop's."""
    cfg = dataclasses.replace(tconfigs.get_smoke("whisper-medium"),
                              num_layers=6, encoder_layers=6)
    kw = dict(device="cpu", mesh=mesh2x4, sharding_mode="tp")
    replayed, _ = steps.trace_step(cfg, smoke_shape("decode"), **kw)
    monkeypatch.setattr(L, "STEP_COUNTERS", [])
    whole, _ = steps.trace_step(cfg, smoke_shape("decode"), **kw)
    _same(replayed, whole)
    assert replayed.collectives == whole.collectives
    assert replayed.collectives.total_bytes > 0


def test_head_split_attention_equals_the_unsplit_attention():
    """The decode's attention on 4 ranks' head shards (q's heads and k's
    and v's KV heads split alike, each rank over the whole sequence, its
    padded tail masked by `kv_len`), rank by rank on real tensors and put
    together on the heads, equals `blocked_attention` unsplit, within
    `tests/test_kernels.py`'s fp32 tolerance."""
    rng = np.random.default_rng(0)
    B, S, H, KV, hd, ranks = 2, 200, 8, 4, 16, 4
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               for s in ((B, 1, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    kw = dict(causal=False, kv_block=64, kv_len=torch.tensor(150))
    whole = L.blocked_attention(q, k, v, **kw)
    parts = [L.blocked_attention(qr, kr, vr, **kw) for qr, kr, vr in zip(
        q.chunk(ranks, 2), k.chunk(ranks, 2), v.chunk(ranks, 2))]
    np.testing.assert_allclose(torch.cat(parts, 2).numpy(), whole.numpy(),
                               rtol=2e-4, atol=2e-4)


def test_a_kv_head_count_the_split_does_not_divide_raises(mesh2x4):
    """2 KV heads do not split over the 4 ranks of a cache's sequence
    split: the attention raises, naming the placements."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    def place(shape, *pl):
        return distribute_tensor(torch.empty(shape), mesh2x4, pl,
                                 src_data_rank=None)

    with FakeTensorMode():
        q = place((8, 1, 4, 16), Shard(0), Replicate())
        k = place((8, 64, 2, 16), Shard(0), Shard(1))
        with pytest.raises(ValueError, match=r"Shard\(dim=1\).*: its 2 KV "
                           r"heads do not split over the 4 ranks"):
            L.blocked_attention(q, k, k, causal=False, kv_block=16)
