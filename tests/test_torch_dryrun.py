"""`repro_torch.launch.dryrun` and `launch.steps.trace_step` on the CPU, at
smoke size: the FLOPs (matmul and elementwise), transcendentals, bytes and
peak counted on fake tensors equal those of the same step run for real
(a train step's too), and a closed-form matmul FLOP count and a hand
count; the records carry the reference record's keys (a train cell's its
remat and microbatches); inapplicable cells are SKIPPED; a scan counts
a few of its steps for all, its backward too, as the whole loop counts.
Counts are integers and compared exactly."""

import dataclasses
import json
import math

import pytest
import torch
from torch.utils import _pytree as pytree

from repro_torch import configs
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core.roofline import (CollectiveStats, analytic_hbm_bytes,
                                       model_flops, roofline_from_totals)
from repro_torch.launch import dryrun
from repro_torch.launch.steps import (build_model, count_step,
                                      make_prefill_step, make_serve_step,
                                      make_train_step, trace_step)
from repro_torch.optim import adamw_init
from repro_torch.models.lm import padded_vocab

# the keys of an OK record of the reference's run_cell
# (src/repro/launch/dryrun.py, the `rec` of its try block)
REF_OK_KEYS = {"cell", "status", "lower_s", "compile_s", "total_s",
               "memory_analysis", "fits_hbm", "roofline", "probes",
               "config"}
REF_CONFIG_KEYS = {"sharding_mode", "remat", "microbatches", "overrides",
                   "rule_updates"}
PREFILL = ShapeSpec("prefill_64x2", 64, 2, "prefill")
DECODE = ShapeSpec("decode_64x2", 64, 2, "decode")


@pytest.fixture
def smoke_registry(monkeypatch):
    """`run_cell` on the smoke configs (same families, small widths)."""
    monkeypatch.setattr(dryrun.configs, "get_arch", configs.get_smoke)


def _real_counts(arch, shape, rt, microbatches=1):
    model = build_model(arch)
    params = model.init(torch.Generator().manual_seed(0), rt)
    B, S = shape.global_batch, shape.seq_len
    if shape.mode == "train":
        batch = {"tokens": torch.randint(0, arch.vocab_size, (B, S),
                                         generator=torch.Generator()
                                         .manual_seed(1))}
        if arch.is_encdec:
            batch["frames"] = torch.randn(
                (B, arch.encoder_seq, arch.d_model),
                generator=torch.Generator().manual_seed(2)).bfloat16()
        return count_step(make_train_step(model, rt,
                                          microbatches=microbatches),
                          params, adamw_init(params), batch)[1]
    if shape.mode == "prefill":
        batch = {"tokens": torch.randint(0, arch.vocab_size, (B, S),
                                         generator=torch.Generator()
                                         .manual_seed(1))}
        if arch.is_encdec:
            batch["frames"] = torch.randn(
                (B, arch.encoder_seq, arch.d_model),
                generator=torch.Generator().manual_seed(2)).bfloat16()
        return count_step(make_prefill_step(model, rt), params, batch)[1]
    cache = model.init_cache(B, S, rt, "cpu")
    return count_step(make_serve_step(model, rt), params, cache,
                      torch.zeros((B, 1), dtype=torch.int64),
                      torch.tensor(S - 1))[1]


@pytest.mark.parametrize("shape", [PREFILL, DECODE], ids=lambda s: s.mode)
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "recurrentgemma-9b",
                                  "olmoe-1b-7b", "deepseek-v2-lite-16b",
                                  "xlstm-1.3b", "whisper-medium",
                                  "qwen2.5-32b-f8"])
def test_fake_counts_equal_a_real_run(arch, shape):
    """Counted on fake tensors = counted on a real run; whisper's scans
    over layers count one step for all (its decode's caches written in
    place, no stack), qwen2.5-32b's decode over the f8 cache."""
    arch, f8, _ = arch.partition("-f8")
    cfg = configs.get_smoke(arch)
    fake, rt = trace_step(cfg, shape, device="cpu",
                          overrides={"kv_dtype": "f8"} if f8 else None)
    real = _real_counts(cfg, shape, rt)
    assert rt.param_dtype == torch.bfloat16 and not rt.use_kernels
    assert fake.flops == real.flops > 0
    assert fake.matmul_flops == real.matmul_flops > 0
    assert fake.elementwise_flops == real.elementwise_flops > 0
    assert fake.transcendentals == real.transcendentals > 0
    assert fake.flops == fake.matmul_flops + fake.elementwise_flops
    assert fake.flops_by_op == real.flops_by_op
    assert fake.bytes_accessed == real.bytes_accessed > 0
    assert fake.peak_bytes == real.peak_bytes > 0
    assert fake.ops == real.ops


TRAIN = ShapeSpec("train_32x4", 32, 4, "train")


@pytest.mark.parametrize("remat,microbatches", [("full", 2), ("none", 1),
                                                ("dots", 1)])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "recurrentgemma-9b",
                                  "olmoe-1b-7b", "deepseek-v2-lite-16b",
                                  "xlstm-1.3b", "whisper-medium"])
def test_fake_train_counts_equal_a_real_run(arch, remat, microbatches):
    """A train step (forward, backward with its remat recompute, AdamW)
    counted on fake tensors = counted on a real run, the backward's ops
    and a scan's every step included."""
    cfg = configs.get_smoke(arch)
    fake, rt = trace_step(cfg, TRAIN, device="cpu", remat=remat,
                          microbatches=microbatches)
    real = _real_counts(cfg, TRAIN, rt, microbatches)
    assert rt.param_dtype == torch.float32 and rt.remat == remat
    assert fake.flops == real.flops > 0
    assert fake.matmul_flops == real.matmul_flops > 0
    assert fake.elementwise_flops == real.elementwise_flops > 0
    assert fake.transcendentals == real.transcendentals > 0
    assert fake.flops_by_op == real.flops_by_op
    assert fake.bytes_accessed == real.bytes_accessed > 0
    assert fake.peak_bytes == real.peak_bytes > 0
    assert fake.ops == real.ops


def _closed_form_flops(cfg, B, S, mode, kv_block):
    """The matmul-family FLOPs of the plain dense-GQA step: q/k/v/o and
    the SwiGLU projections per token, scores and values over every
    (query, key) pair of the blocked attention (it masks, it does not
    skip; its keys padded to a multiple of the KV block, as the
    reference's), and the LM head on the last position only (prefill) or
    the one new token (decode)."""
    d, H, KV, hd, f = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                       cfg.resolved_head_dim, cfg.d_ff)
    tokens = B * S if mode == "prefill" else B
    # prefill: S keys padded to the KV block; decode: the cache
    keys = -(-S // kv_block) * kv_block if mode == "prefill" else S
    per_token = 2 * d * (H * hd + 2 * KV * hd) + 2 * H * hd * d \
        + 3 * 2 * d * f
    attn = 4 * B * H * hd * keys * (S if mode == "prefill" else 1)
    head = 2 * B * d * padded_vocab(cfg.vocab_size)
    return cfg.num_layers * (tokens * per_token + attn) + head


@pytest.mark.parametrize("shape", [PREFILL, DECODE], ids=lambda s: s.mode)
def test_fake_flops_match_the_closed_form(shape):
    """The matmul family's FLOPs; the elementwise ones are counted apart
    (`test_elementwise_flops_match_a_hand_count`,
    tests/test_torch_flops.py)."""
    cfg = configs.get_smoke("qwen2-0.5b")
    fake, rt = trace_step(cfg, shape, device="cpu")
    assert fake.matmul_flops == _closed_form_flops(
        cfg, shape.global_batch, shape.seq_len, shape.mode,
        rt.attn_kv_block)
    assert sum(fake.flops_by_op.values()) == fake.matmul_flops


def test_elementwise_flops_match_a_hand_count():
    """x [4, 8], y [4, 8] fp32: sigmoid (XLA: 1 / (1 + exp(-x)), 3 FLOPs
    and 1 transcendental an element), a product, a row sum (7 adds a row),
    a broadcast add, a bf16 convert (1 an element), a copy (0), and a
    4 x 8 @ 8 x 4 product (2 M K N, counted apart)."""
    def fn(x, y):
        h = torch.sigmoid(x) * y                  # 3 * 32 + 32, exp 32
        h = h + h.sum(-1, keepdim=True)           # 4 * 7 + 32
        return h.to(torch.bfloat16).clone(), x @ y.T   # 32 + 0; 2 * 128
    counts = count_step(fn, torch.ones(4, 8), torch.ones(4, 8))[1]
    assert counts.elementwise_flops == 3 * 32 + 32 + 4 * 7 + 32 + 32
    assert counts.transcendentals == 32
    assert counts.matmul_flops == 2 * 4 * 8 * 4
    assert counts.flops == counts.matmul_flops + counts.elementwise_flops


def test_kv_block_moves_the_peak_not_the_flops():
    """The KV block sets the peak, not the matmul FLOPs; its elementwise
    FLOPs grow with the number of blocks (the online softmax rescales its
    running sums once a block)."""
    cfg = configs.get_smoke("qwen2-0.5b")
    shape = ShapeSpec("p", 512, 2, "prefill")
    small, rt = trace_step(cfg, shape, device="cpu",
                           overrides={"attn_kv_block": 64})
    large, _ = trace_step(cfg, shape, device="cpu",
                          overrides={"attn_kv_block": 512})
    assert rt.attn_kv_block == 64
    assert small.matmul_flops == large.matmul_flops
    assert small.elementwise_flops > large.elementwise_flops
    assert small.peak_bytes < large.peak_bytes


def test_run_cell_record_carries_the_reference_keys(tmp_path,
                                                    smoke_registry):
    rec = dryrun.run_cell("qwen2-0.5b", "decode_32k", tmp_path,
                          device="cpu", tag="_t")
    assert rec["status"] == "OK" and rec["cell"] == \
        "qwen2-0.5b_decode_32k_1gpu_t"
    assert REF_OK_KEYS <= set(rec)
    assert set(rec["config"]) == REF_CONFIG_KEYS
    assert json.loads((tmp_path / f"{rec['cell']}.json").read_text()) == rec
    # the roofline is the one of the counts, on one H100
    cfg, shape = configs.get_smoke("qwen2-0.5b"), \
        configs.shape_by_name("decode_32k")
    counts, _ = trace_step(cfg, shape, device="cpu")
    want = roofline_from_totals(
        arch="qwen2-0.5b", shape="decode_32k", mesh_name="1gpu", chips=1,
        flops=counts.flops, hbm_bytes=counts.bytes_accessed,
        coll=CollectiveStats(), peak_bytes=counts.peak_bytes,
        analytic_bytes=analytic_hbm_bytes(cfg, shape, 1, tp=1),
        model_flops_total=model_flops(cfg, shape))
    assert rec["roofline"] == want.to_json()
    assert rec["fits_hbm"] == (counts.peak_bytes <= 80e9)
    assert rec["flops_by_op"] == counts.flops_by_op
    assert (rec["matmul_flops"], rec["elementwise_flops"],
            rec["transcendentals"]) == (counts.matmul_flops,
                                        counts.elementwise_flops,
                                        counts.transcendentals)


def test_run_cell_records_the_execution_point(tmp_path, smoke_registry):
    rec = dryrun.run_cell("recurrentgemma-9b", "decode_32k", tmp_path,
                          device="cpu", sharding_mode="tp", remat="none",
                          overrides={"attn_kv_block": 512,
                                     "moe_group_size": 4096},
                          rule_updates={"kv_seq": None})
    assert rec["status"] == "OK"
    assert rec["config"] == {"sharding_mode": "tp", "remat": "none",
                             "microbatches": 1,
                             "overrides": {"attn_kv_block": 512,
                                           "moe_group_size": 4096},
                             "rule_updates": {"kv_seq": "None"}}
    assert rec["runtime"]["attn_kv_block"] == 512


def test_inapplicable_cell_is_skipped(tmp_path, smoke_registry):
    rec = dryrun.run_cell("qwen2-0.5b", "long_500k", tmp_path, device="cpu")
    assert rec["status"] == "SKIPPED" and "500k" in rec["reason"]


TRAIN_SMALL = ShapeSpec("train_4k", 32, 8, "train")


@pytest.fixture
def small_train(monkeypatch, smoke_registry):
    """`run_cell`'s train_4k at batch 8 x seq 32 (smoke widths), so a
    cell counts in seconds."""
    monkeypatch.setattr(dryrun, "shape_by_name", lambda name: TRAIN_SMALL)


@pytest.mark.parametrize("arch,microbatches", [
    ("qwen2-0.5b", 2), ("recurrentgemma-9b", 8), ("olmoe-1b-7b", 2),
    ("deepseek-v2-lite-16b", 2), ("whisper-medium", 2), ("xlstm-1.3b", 4)])
def test_train_cells_are_counted(tmp_path, small_train, arch, microbatches):
    """A train cell: an OK record with a finite peak and roofline, its
    three FLOP counts, and `remat` and `microbatches` in its config (the
    reference's `DEFAULT_MICROBATCHES`); its runtime is the reference's
    train runtime (fp32 params, bf16 compute, remat "full")."""
    rec = dryrun.run_cell(arch, "train_4k", tmp_path, device="cpu")
    assert rec["status"] == "OK", rec.get("error")
    assert REF_OK_KEYS <= rec.keys()
    assert rec["config"]["remat"] == "full"
    assert rec["config"]["microbatches"] == microbatches \
        == dryrun.DEFAULT_MICROBATCHES[arch]
    assert rec["runtime"]["param_dtype"] == "torch.float32"
    assert rec["runtime"]["compute_dtype"] == "torch.bfloat16"
    assert rec["runtime"]["remat"] == "full"
    assert 0 < rec["roofline"]["roofline_s"] < float("inf")
    assert rec["matmul_flops"] > 0 and rec["elementwise_flops"] > 0
    assert rec["transcendentals"] > 0
    assert rec["analytic_bytes"] == analytic_hbm_bytes(
        configs.get_smoke(arch), TRAIN_SMALL, 1, tp=1,
        microbatches=microbatches)


def test_train_cell_remat_and_microbatches_move_the_step(tmp_path,
                                                        small_train):
    """On one GPU remat and microbatches change a train step (they change
    nothing in a serving step): "full" recomputes the forward in the
    backward (more FLOPs, a lower peak than "none"), "dots" recomputes
    the batched products only, and more microbatches hold fewer
    activations at once."""
    rec = {(r, m): dryrun.run_cell("qwen2-0.5b", "train_4k", tmp_path,
                                   device="cpu", remat=r, microbatches=m,
                                   tag=f"_{r}{m}")
           for r in ("none", "full", "dots") for m in (1, 4)}
    peak = {k: v["roofline"]["peak_memory_per_chip"] for k, v in rec.items()}
    mm = {k: v["matmul_flops"] for k, v in rec.items()}
    assert mm[("none", 1)] < mm[("dots", 1)] < mm[("full", 1)]
    assert peak[("full", 1)] < peak[("none", 1)]
    assert peak[("none", 4)] < peak[("none", 1)]
    assert mm[("none", 4)] == mm[("none", 1)]


@pytest.mark.parametrize("arch,shape,kv", [
    ("whisper-medium", "prefill_32k", "bf16"),      # encoder-decoder
    ("whisper-medium", "decode_32k", "bf16"),
    ("qwen2.5-32b", "decode_32k", "f8"),    # the reference's fp8 KV cache
])
def test_whisper_and_f8_cells_are_counted(tmp_path, smoke_registry, arch,
                                          shape, kv):
    """The cells that raised before: OK records with a finite peak and
    roofline; the f8 cell's analytic traffic counts its cache at one byte
    an element, as the reference's `analytic_hbm_bytes(...,
    kv_bytes=1)`, and its peak holds the cache at one byte."""
    from repro import configs as ref_configs
    from repro.core.roofline import analytic_hbm_bytes as ref_analytic

    rec = dryrun.run_cell(arch, shape, tmp_path, device="cpu")
    assert rec["status"] == "OK", rec.get("error")
    assert 0 < rec["roofline"]["roofline_s"] < float("inf")
    assert rec["runtime"]["kv_dtype"] == kv
    kv_bytes = 1 if kv == "f8" else 2
    assert rec["runtime"]["kv_bytes"] == kv_bytes
    want = ref_analytic(ref_configs.get_smoke(arch),
                        ref_configs.shape_by_name(shape), 1, tp=1,
                        kv_bytes=kv_bytes)
    assert rec["analytic_bytes"] == want > 0
    if kv == "f8":
        sh = configs.shape_by_name(shape)
        cache = sum(math.prod(s.shape) for s in pytree.tree_leaves(
            build_model(configs.get_smoke(arch)).cache_specs(
                sh.global_batch, sh.seq_len)))
        bf16 = dryrun.run_cell(arch, shape, tmp_path, device="cpu",
                               overrides={"kv_dtype": "bf16"}, tag="_bf16")
        # the same step over a bf16 cache holds one byte an element more
        assert bf16["roofline"]["peak_memory_per_chip"] - \
            rec["roofline"]["peak_memory_per_chip"] == cache


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-lite-16b"])
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_moe_cells_are_counted(tmp_path, smoke_registry, arch, shape):
    """The MoE archs' serving cells at their full batch and length (smoke
    widths): OK records with a finite peak and roofline, the MoE block's
    group size recorded."""
    rec = dryrun.run_cell(arch, shape, tmp_path, device="cpu")
    assert rec["status"] == "OK", rec.get("error")
    assert 0 < rec["roofline"]["roofline_s"] < float("inf")
    assert rec["runtime"]["moe_group_size"] == 4096


def test_moe_group_size_moves_the_moe_step():
    """`moe_group_size` reaches the MoE block (it was dropped before the
    runtime): two of the sizes `exec_space(has_moe=True)` offers give two
    different counts of olmoe's smoke prefill at 8192 tokens.  The groups
    are routed together on one GPU and the capacity a group gives an
    expert scales with the group, so the expert products (the matmul
    FLOPs) stay; the dispatch's traffic and op count move."""
    from repro_torch.core.autotune import exec_space

    sizes = exec_space("prefill", has_moe=True).domains["moe_group_size"]
    assert sizes == (2048, 4096, 8192)
    shape = ShapeSpec("prefill_8192x1", 8192, 1, "prefill")
    cfg = configs.get_smoke("olmoe-1b-7b")
    counts = {}
    for g in (sizes[0], sizes[-1]):
        counts[g], rt = trace_step(cfg, shape, device="cpu",
                                   overrides={"moe_group_size": g})
        assert rt.moe_group_size == g
    small, big = counts[sizes[0]], counts[sizes[-1]]
    assert small.matmul_flops == big.matmul_flops
    assert (small.bytes_accessed, small.ops) != (big.bytes_accessed, big.ops)


def test_cli_writes_a_record_with_a_roofline(tmp_path, smoke_registry,
                                             capsys):
    assert dryrun.main(["--arch", "qwen2-0.5b", "--shape", "prefill_32k",
                        "--device", "cpu", "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "qwen2-0.5b_prefill_32k_1gpu.json")
                     .read_text())
    assert rec["status"] == "OK" and rec["device"] == "cpu"
    assert rec["roofline"]["roofline_s"] > 0
    assert "OK peak=" in capsys.readouterr().out


def test_cli_defaults_to_cuda_and_refuses_without_a_gpu(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a GPU"):
        dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k",
                     "--out", str(tmp_path)])


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "long_500k"])
def test_xlstm_cells_are_counted(tmp_path, smoke_registry, shape):
    """xlstm-1.3b's three serving cells at their full batch and length
    (smoke widths), `long_500k` included (a sub-quadratic arch's: one token
    against a 524,288-token context, which the recurrent state does not
    grow with): OK records with a finite peak and roofline."""
    rec = dryrun.run_cell("xlstm-1.3b", shape, tmp_path, device="cpu")
    assert rec["status"] == "OK", rec.get("error")
    assert 0 < rec["roofline"]["roofline_s"] < float("inf")
    assert rec["runtime"]["param_dtype"] == "torch.bfloat16"


@pytest.mark.parametrize("arch,shape", [
    ("xlstm-1.3b", ShapeSpec("prefill_600x2", 600, 2, "prefill")),
    ("whisper-medium", DECODE)],
    ids=["xlstm-prefill", "whisper-decode"])
def test_a_scan_is_counted_once_for_all_its_steps(arch, shape, monkeypatch):
    """`layers.scan` under `count_step` runs four steps and counts one for
    the middle ones: xlstm-1.3b's smoke prefill at S 600 (an mLSTM chunk
    of 96: seven chunks, the last padded; the sLSTM's 600 steps) and
    whisper-medium's smoke decode at six layers (its caches written in
    place, each layer's slice) count what the whole loop counts, every
    field, the peak included."""
    from repro_torch.models import layers

    cfg = configs.get_smoke(arch)
    if arch == "whisper-medium":
        cfg = dataclasses.replace(cfg, num_layers=6, encoder_layers=6)
    ov = {"mlstm_chunk": 96}
    once, _ = trace_step(cfg, shape, device="cpu", overrides=ov)
    monkeypatch.setattr(layers, "STEP_COUNTERS", [])    # the whole loop
    whole, _ = trace_step(cfg, shape, device="cpu", overrides=ov)
    assert once == whole
    # the sLSTM's some 25 ops a step on 2 layers; the decode's a layer
    assert once.ops > {"xlstm-1.3b": 600 * 6 * 2,
                       "whisper-medium": 6 * 20}[arch] and once.flops > 0


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "whisper-medium"])
def test_microbatches_count_one_for_all_exactly(arch, monkeypatch):
    """Counted, a train step runs its first microbatch for all
    (`_Counter.repeat`): the counts and the peak equal those of the step
    that runs every microbatch."""
    from repro_torch.launch import steps
    cfg = configs.get_smoke(arch)
    one_for_all, _ = trace_step(cfg, TRAIN, device="cpu", microbatches=4)

    def every(self, fn, n):           # each microbatch run and counted
        for _ in range(n - 1):
            fn()
        return fn()
    monkeypatch.setattr(steps._Counter, "repeat", every)
    each, _ = trace_step(cfg, TRAIN, device="cpu", microbatches=4)
    assert one_for_all == each


def _every_scan_step(monkeypatch):
    """Count as the step that runs every scan step: `layers.scan` runs
    its loop (microbatches still count one for all, exactly:
    `test_microbatches_count_one_for_all_exactly`)."""
    from repro_torch.models import layers

    monkeypatch.setattr(layers, "STEP_COUNTERS", [])


# xlstm-1.3b's smoke widths at one mLSTM and one sLSTM block, an mLSTM
# chunk of 24: five chunks, the last padded, and the sLSTM's 110 steps
REPLAY = ShapeSpec("train_110x2", 110, 2, "train")


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_a_train_steps_scans_count_a_step_for_the_middle_ones(
        remat, microbatches, monkeypatch):
    """Under grad `layers.scan` runs its first, second, third and last
    steps and counts the second for the middle ones, forward, backward
    and recompute (`_Counter.replay_scan`), inside the microbatches'
    repeat: xlstm-1.3b's train step counts what the step that runs every
    scan step counts, in every field, the peak included."""
    cfg = dataclasses.replace(configs.get_smoke("xlstm-1.3b"), num_layers=2,
                              block_pattern=("mlstm", "slstm"))
    kw = dict(device="cpu", remat=remat, microbatches=microbatches,
              overrides={"mlstm_chunk": 24})
    replayed, rt = trace_step(cfg, REPLAY, **kw)
    assert rt.mlstm_chunk == 24 and REPLAY.seq_len % 24 \
        and -(-REPLAY.seq_len // 24) == 5
    _every_scan_step(monkeypatch)
    whole, _ = trace_step(cfg, REPLAY, **kw)
    assert replayed == whole
    assert replayed.ops > 110 * 3 and replayed.peak_bytes > 0


@pytest.mark.parametrize("remat", ["none", "full"])
def test_an_encoder_decoders_layer_scans_count_a_step_for_the_middle_ones(
        remat, monkeypatch):
    """whisper-medium's layers are scans too, under "full" each step's
    body checkpointed (its recompute runs inside the step's backward): at
    six encoder and six decoder layers the train step counts what the
    whole loop counts, every field."""
    cfg = dataclasses.replace(configs.get_smoke("whisper-medium"),
                              num_layers=6, encoder_layers=6)
    replayed, _ = trace_step(cfg, TRAIN, device="cpu", remat=remat,
                             microbatches=2)
    _every_scan_step(monkeypatch)
    whole, _ = trace_step(cfg, TRAIN, device="cpu", remat=remat,
                          microbatches=2)
    assert replayed == whole


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "recurrentgemma-9b"])
def test_train_steps_with_no_scan_replay_none(arch, monkeypatch):
    """The decoders whose train steps run no `layers.scan` replay nothing:
    their counts are those of the step with every scan step run."""
    from repro_torch.launch import steps

    def refuse(*args):
        raise AssertionError("a scan was replayed")
    monkeypatch.setattr(steps._Counter, "replay_scan", refuse)
    cfg = configs.get_smoke(arch)
    counted, _ = trace_step(cfg, TRAIN, device="cpu", microbatches=2)
    _every_scan_step(monkeypatch)
    whole, _ = trace_step(cfg, TRAIN, device="cpu", microbatches=2)
    assert counted == whole
