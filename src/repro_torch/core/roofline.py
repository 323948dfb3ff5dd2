"""Roofline of one step on one H100, from counts taken on fake tensors.

Three terms per (arch x shape) cell, in seconds:

  compute term    = FLOPs            / peak FLOP/s  (bf16 tensor cores)
  memory term     = bytes            / HBM bytes/s
  collective term = collective bytes / link bytes/s (0 on one chip)

The reference (`repro.core.roofline`) reads FLOPs and bytes from XLA's
`cost_analysis()` of a compiled program; the port counts them while the
step runs on fake tensors (`launch.steps.trace_step`).  The report, the
totals-to-roofline arithmetic and the analytic models (`analytic_hbm_bytes`,
`model_flops`) are the reference's, copied as they are.

This module is also the cost model of the execution-space DSE
(`core.autotune`).  Reading XLA's HLO and compiled objects
(`parse_collective_bytes`, `measure_compiled`, `analyze_compiled`) is
ported with the distributed slice, see ROADMAP.md.
"""

from __future__ import annotations

import dataclasses
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


@dataclasses.dataclass
class CollectiveStats:
    total_bytes: int = 0
    by_kind: Dict[str, int] = dataclasses.field(default_factory=dict)
    count: int = 0

    def add(self, kind: str, nbytes: int) -> None:
        self.total_bytes += nbytes
        self.by_kind[kind] = self.by_kind.get(kind, 0) + nbytes
        self.count += 1


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is ported in a later slice (the "
                               "distributed one), see ROADMAP.md")


def parse_collective_bytes(hlo_text: str) -> CollectiveStats:
    raise _not_ported("parse_collective_bytes (reads XLA HLO)")


def measure_compiled(compiled):
    raise _not_ported("measure_compiled (reads an XLA executable)")


def analyze_compiled(compiled, **kwargs):
    raise _not_ported("analyze_compiled (reads an XLA executable)")


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
