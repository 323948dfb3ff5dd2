"""Roofline of one step per H100, from counts taken on fake tensors.

Three terms per (arch x shape x mesh) cell, in seconds, per card:

  compute term    = FLOPs            / peak FLOP/s  (bf16 tensor cores)
  memory term     = bytes            / HBM bytes/s
  collective term = collective bytes / link bytes/s (0 on one card)

The reference (`repro.core.roofline`) reads FLOPs and bytes from XLA's
`cost_analysis()` of a compiled program, per partition, and the collective
bytes from its post-SPMD HLO (`parse_collective_bytes`); the port counts
all three while the step runs on fake tensors (`launch.steps.trace_step`),
over a mesh on rank 0's DTensor shards, its collectives by kind and result
bytes.  The report, the totals-to-roofline arithmetic and the analytic
models (`analytic_hbm_bytes`, `model_flops`) are the reference's, copied
as they are, and so is `parse_collective_bytes`, a function of HLO text.

`HW.ici_bw` is one H100's NVLink rate (450 GB/s each way), the link
between the 8 cards of a node.  The collective term divides every rank's
collective bytes by it, as if every mesh axis ran over NVLink: on a 16x16
or 2x16x16 mesh of 8-card nodes most axes cross nodes over the network,
which is slower, so the term is a lower bound there.

This module is also the cost model of the execution-space DSE
(`core.autotune`).  `measure_compiled` and `analyze_compiled` read an XLA
executable, which the port never has: its counterpart is
`launch.steps.count_step` (and `launch.dryrun.run_cell` for a cell).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict

__all__ = ["HW", "CollectiveStats", "parse_collective_bytes",
           "RooflineReport", "measure_compiled", "analyze_compiled",
           "roofline_from_totals", "analytic_hbm_bytes", "model_flops"]


@dataclasses.dataclass(frozen=True)
class HW:
    """One NVIDIA H100 SXM, from NVIDIA's data sheet (dense rates, at the
    full 700 W power limit)."""

    peak_flops: float = 989e12         # bf16 / fp16 tensor cores
    hbm_bw: float = 3.35e12            # HBM3, bytes/s
    ici_bw: float = 450e9              # NVLink, bytes/s each way
    hbm_bytes: float = 80e9            # capacity
    fp32_flops: float = 67e12          # fp32 FMA on the CUDA cores


_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

_SHAPE_RE = re.compile(r"(f64|f32|f16|bf16|f8e4m3fn|f8e5m2|s64|u64|s32|u32|"
                       r"s16|u16|s8|u8|pred|c64|c128)\[([0-9,]*)\]")
_INSTR_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?[\w.\-]+\s*=\s*(\(?[^=]*?\)?)\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(-start|-done)?\(", re.M)


def _shape_bytes(shape_text: str) -> int:
    total = 0
    for m in _SHAPE_RE.finditer(shape_text):
        dt, dims = m.group(1), m.group(2)
        n = 1
        if dims:
            for d in dims.split(","):
                if d:
                    n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


@dataclasses.dataclass
class CollectiveStats:
    total_bytes: int = 0
    by_kind: Dict[str, int] = dataclasses.field(default_factory=dict)
    count: int = 0

    def add(self, kind: str, nbytes: int, count: int = 1) -> None:
        """`count` collectives of `kind` moving `nbytes` in all."""
        self.total_bytes += nbytes
        self.by_kind[kind] = self.by_kind.get(kind, 0) + nbytes
        self.count += count


def parse_collective_bytes(hlo_text: str) -> CollectiveStats:
    """Sum result-shape bytes of every collective in a post-SPMD HLO."""
    stats = CollectiveStats()
    for m in _INSTR_RE.finditer(hlo_text):
        shape_text, kind, phase = m.group(1), m.group(2), m.group(3)
        if phase == "-done":       # avoid double-counting async pairs
            continue
        stats.add(kind, _shape_bytes(shape_text))
    return stats


def _no_executable(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} reads an XLA executable, which the port never has: a "
        "step's counts per rank, its collectives included, come from "
        "launch.steps.count_step, a cell's record from "
        "launch.dryrun.run_cell")


def measure_compiled(compiled):
    raise _no_executable("measure_compiled")


def analyze_compiled(compiled, **kwargs):
    raise _no_executable("analyze_compiled")


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    hbm_bytes_per_chip: float
    collective_bytes_per_chip: float
    peak_memory_per_chip: float
    compute_s: float
    memory_s: float                    # primary: analytic traffic model
    memory_s_hlo: float                # upper bound: pre-fusion HLO bytes
    collective_s: float
    bottleneck: str
    model_flops_total: float
    useful_compute_ratio: float        # MODEL_FLOPS / (HLO_FLOPs x chips)
    roofline_s: float                  # max of the three terms
    collective_detail: Dict[str, int]

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: Dict) -> "RooflineReport":
        return RooflineReport(**d)

    def row(self) -> str:
        return (f"{self.arch:22s} {self.shape:12s} {self.mesh:6s} "
                f"comp={self.compute_s*1e3:9.3f}ms "
                f"mem={self.memory_s*1e3:9.3f}ms "
                f"coll={self.collective_s*1e3:9.3f}ms "
                f"-> {self.bottleneck:9s} "
                f"useful={self.useful_compute_ratio:6.1%}")


def roofline_from_totals(*, arch: str, shape: str, mesh_name: str,
                         chips: int, flops: float, hbm_bytes: float,
                         coll: CollectiveStats, peak_bytes: float,
                         model_flops_total: float,
                         analytic_bytes: float = 0.0,
                         hw: HW = HW()) -> RooflineReport:
    compute_s = flops / hw.peak_flops
    memory_s_hlo = hbm_bytes / hw.hbm_bw
    # primary memory term: the analytic traffic model when available (the
    # CPU backend's pre-fusion byte count is only an upper bound)
    memory_s = (analytic_bytes / hw.hbm_bw) if analytic_bytes \
        else memory_s_hlo
    collective_s = coll.total_bytes / hw.ici_bw
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    total_hlo_flops = flops * chips
    useful = model_flops_total / total_hlo_flops if total_hlo_flops else 0.0
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_chip=flops, hbm_bytes_per_chip=hbm_bytes,
        collective_bytes_per_chip=float(coll.total_bytes),
        peak_memory_per_chip=peak_bytes,
        compute_s=compute_s, memory_s=memory_s, memory_s_hlo=memory_s_hlo,
        collective_s=collective_s,
        bottleneck=bottleneck, model_flops_total=model_flops_total,
        useful_compute_ratio=useful, roofline_s=max(terms.values()),
        collective_detail=dict(coll.by_kind))


def analytic_hbm_bytes(arch, shape, chips: int, *, microbatches: int = 1,
                       tp: int = 16, kv_bytes: int = 2) -> float:
    """Modeled per-chip HBM traffic per step (bytes).

    XLA:CPU's cost_analysis reports *pre-fusion* "bytes accessed" — every
    op's operands+results — which overstates real HBM traffic severely
    (a masked KV-cache write alone triples the cache bytes).  This model
    counts the unavoidable movements:

      train   : weight reads fwd+bwd per microbatch (TP-resident copies),
                gradient writes, optimizer read/write (fp32 m, v, p),
                activation-checkpoint saves+reads, logits traffic
      prefill : weight reads + boundary activations + logits
      decode  : weight reads + KV-cache read + write + state traffic

    It is a lower bound (ignores transient spills); the HLO number is kept
    alongside as the upper bound.
    """
    n = arch.param_count()
    d = arch.d_model
    L = arch.num_layers + arch.encoder_layers
    B, S = shape.global_batch, shape.seq_len
    if shape.mode == "train":
        b_loc = max(B // min(chips // tp, B), 1) / max(microbatches, 1)
        w_read = 2.0 * (n / tp) * 4 * microbatches      # fwd+bwd, fp32
        g_write = (n / chips) * 4
        opt = 6.0 * (n / chips) * 4                     # read+write p,m,v
        acts = 2.0 * L * b_loc * S * d * 2 * microbatches
        logits = 3.0 * b_loc * S * (arch.vocab_size / tp) * 2 * microbatches
        return w_read + g_write + opt + acts + logits
    if shape.mode == "prefill":
        b_loc = max(B // min(chips // tp, B), 1)
        w_read = (n / tp) * 2                           # bf16 serving
        acts = 2.0 * L * b_loc * S * d * 2
        return w_read + acts
    # decode
    w_read = (n / tp) * 2
    hd = arch.resolved_head_dim
    if arch.mla is not None:
        per_tok = arch.mla.kv_lora_rank + arch.mla.qk_rope_head_dim
    elif arch.sub_quadratic:
        per_tok = 0                                     # constant state
    else:
        per_tok = 2 * arch.num_kv_heads * hd
    cache_loc = (B * S * per_tok * arch.num_layers * kv_bytes) / chips
    state = 0.0
    if arch.sub_quadratic:
        # recurrent state read+write (mlstm matrix memory dominates xlstm)
        u = 2 * d
        state = 2.0 * B * arch.num_layers * (u // max(arch.num_heads, 1)) \
            * u * 4 / chips
    return w_read + 2.0 * cache_loc + state


def model_flops(arch, shape) -> float:
    """MODEL_FLOPS: 6*N*D for dense training (N params, D tokens);
    6*N_active*D for MoE; 2*N(_active)*D for inference forward; per-step
    token count for decode."""
    n_params = arch.param_count()
    if arch.moe is not None:
        m = arch.moe
        # subtract inactive expert params: each MoE layer activates
        # top_k (+ shared) of num_experts experts
        per_expert = 3 * arch.d_model * m.d_expert
        n_moe_layers = arch.num_layers - m.first_dense
        inactive = n_moe_layers * per_expert * (m.num_experts - m.top_k)
        n_active = n_params - inactive
    else:
        n_active = n_params
    tokens = shape.global_batch * (1 if shape.mode == "decode"
                                   else shape.seq_len)
    mult = 6.0 if shape.mode == "train" else 2.0
    if arch.is_encdec:
        # encoder runs over its own (fixed) frame count; the decoder stack
        # (incl. cross-attention projections + embeddings) over the tokens
        n_enc = arch.encoder_param_count()
        n_dec = n_active - n_enc
        enc_tokens = 0 if shape.mode == "decode" \
            else shape.global_batch * arch.encoder_seq
        flops = mult * (n_enc * enc_tokens + n_dec * tokens)
        if shape.mode == "decode":
            hd = arch.resolved_head_dim
            # self-attn over the cache + cross-attn over encoder frames
            flops += (4.0 * arch.num_layers * arch.num_heads * hd
                      * (shape.seq_len + arch.encoder_seq)
                      * shape.global_batch)
        return flops
    flops = mult * n_active * tokens
    if shape.mode == "decode" and not arch.sub_quadratic:
        # attention over the KV cache: 2 * 2 * L * H * hd * S per token
        hd = arch.resolved_head_dim
        flops += (4.0 * arch.num_layers * arch.num_heads * hd
                  * shape.seq_len * shape.global_batch)
    return flops
