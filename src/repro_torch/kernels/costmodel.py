"""Fused (GOPS, area) scorer on a torch device.

`FusedTorchScorer` is the port's twin of the JAX package's
`FusedJaxScorer`, with the same contract: `metrics(matrix)` returns what
`(performance_gops(batch, ...), area_many(batch, ...))` returns for a
`ConfigBatch` matrix.  The per-(stream, hw, value-set) gather tables are
built on the host by `repro_torch.core.costmodel._fused_tables_for` and
uploaded to the device once per table build (`DeviceTables`, which the
table pass of `evaluate_stream_many` uses too).  Per call the host only
codes the pool matrix against the tables (`_FusedTables.codes`, numpy);
the device runs the rest in int64/float64:

  * the Eq. (9)-(13) validity screen, whose five `[C, O]` table gathers go
    through `gather_rows` (the hand-written CUDA kernel on a GPU, its
    plain PyTorch version on the CPU);
  * the Eq. (1)-(8) latency tail on the rows that pass the screen;
  * the §4.3 area polynomial.

Every floating-point operation runs in the operand order of the numpy
`FusedStreamScorer`, and the per-config sum over ops runs in numpy's
pairwise order (`numpy_order_sum`), so results are bit-identical to the
numpy scorer on the CPU.  Divisions by constants divide by 0-dim device
tensors, never by Python scalars: PyTorch's CUDA division by a host scalar
multiplies by its reciprocal, which can differ in the last bit.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.costmodel import (ConfigBatch, DeviceTables,
                                        HardwareConstants, LoopOrder,
                                        OpStream, _FAST_FIELDS,
                                        _TAIL_FIELDS, _area_t,
                                        _fused_tables_for, _table_rows,
                                        _tables_support, numpy_order_sum,
                                        resolve_device, split_rows)
from repro_torch.kernels.gather import gather_rows

__all__ = ["FusedTorchScorer", "numpy_order_sum", "resolve_device"]


class FusedTorchScorer:
    """Device-resident fused (GOPS, area) scorer for `ConfigBatch`
    matrices on one stream, `metrics()`-compatible with the numpy
    `FusedStreamScorer`.

    `n_uploads` counts table uploads (one per table build); `n_calls`
    counts `metrics` calls."""

    def __init__(self, stream: OpStream, hw: HardwareConstants,
                 peak_weight_bits: int = 0, peak_input_bits: int = 0,
                 domains: Optional[Dict[str, Sequence[int]]] = None,
                 device="cuda"):
        if not self.supports(stream):
            raise ValueError("stream not supported by the fused scorer "
                             "(zero-size kernel or stride)")
        self.hw = hw
        self.peak_weight_bits = int(peak_weight_bits)
        self.peak_input_bits = int(peak_input_bits)
        self.device = resolve_device(device)
        self.t = _fused_tables_for(stream, hw, domains)
        self._tables = DeviceTables(self.t, self.device)
        self.n_calls = 0

        def scalar(v: float) -> torch.Tensor:
            return torch.tensor(float(v), dtype=torch.float64,
                                device=self.device)

        self._freq = scalar(hw.frequency_hz)
        self._giga = scalar(1e9)
        self._total_ops = scalar(self.t.total_ops)

    @staticmethod
    def supports(stream: OpStream) -> bool:
        return _tables_support(stream)

    @property
    def n_uploads(self) -> int:
        return self._tables.n_uploads

    # -------------------------------------------------------------- scoring
    def metrics(self, matrix: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(gops[N], area[N]) float64 for an `[N, 18]` config matrix."""
        self.n_calls += 1
        n = matrix.shape[0]
        if n == 0:
            z = np.zeros(0, dtype=np.float64)
            return z, z.copy()
        t, hw = self.t, self.hw
        code = t.codes(matrix)          # may grow and rebuild the tables
        dv, nv = self._tables.get(), t.nvals
        J = ConfigBatch._INDEX
        codes = torch.from_numpy(
            np.stack([code[f] for f in _FAST_FIELDS], axis=1)
        ).to(self.device)
        cols = torch.from_numpy(
            np.ascontiguousarray(matrix[:, [J[f] for f in _TAIL_FIELDS]],
                                 dtype=np.int64)).to(self.device)
        c = {f: codes[:, j] for j, f in enumerate(_FAST_FIELDS)}
        k = {f: cols[:, j] for j, f in enumerate(_TAIL_FIELDS)}
        f64 = torch.float64

        pe_group = k["pe_group"]
        total_macs = pe_group * k["mac_per_group"]
        banks_w = k["weight_banks_pg"] * pe_group * k["bank_width"]
        banks_a = k["act_banks_pg"] * pe_group * k["bank_width"]
        wbuf = banks_w * k["bank_height"]
        abuf = banks_a * k["bank_height"]
        area = _area_t(pe_group, total_macs, wbuf + abuf, hw)     # §4.3

        # joint table rows for the validity screen
        i_u1 = ((c["tif"] * nv["pif"] + c["pif"]) * nv["pkx"]
                + c["pkx"]) * nv["pky"] + c["pky"]
        i_u2 = ((c["tix"] * nv["pox"] + c["pox"]) * nv["tiy"]
                + c["tiy"]) * nv["poy"] + c["poy"]
        i_u3 = (c["tof"] * nv["pof"] + c["pof"]) * nv["pb"] + c["pb"]
        ix = _table_rows(c, nv)

        # Eq. (9): folded unroll product (int64); Eqs. (10) + (12): tiles
        unroll = (gather_rows(dv["u1_tbl"], i_u1)
                  * gather_rows(dv["u2_tbl"], i_u2)
                  * gather_rows(dv["u3_tbl"], i_u3))
        valid_ops = unroll <= total_macs[:, None]
        valid_ops &= wbuf[:, None] >= gather_rows(dv["wt_tile"],
                                                  ix["wt_tbl"])
        valid_ops &= abuf[:, None] >= gather_rows(dv["atile_tbl"],
                                                  ix["atile_tbl"])
        ok = valid_ops.all(dim=1)
        # Eqs. (11) + (13): peak-residency floors are [C]-shaped
        if self.peak_weight_bits:
            ok &= wbuf >= self.peak_weight_bits
        if self.peak_input_bits:
            ok &= abuf >= self.peak_input_bits * t.max_batch

        gops = torch.zeros(n, dtype=f64, device=self.device)
        rows = torch.nonzero(ok).squeeze(1)
        if rows.numel():
            cycles = self._cycles(dv, ix, k, banks_w, banks_a, rows)
            seconds = cycles / self._freq
            gops[rows] = torch.where(
                cycles > 0,
                self._total_ops / torch.clamp(seconds, min=1e-30)
                / self._giga, 0.0)
        return gops.cpu().numpy(), area.cpu().numpy()

    def _cycles(self, dv: Dict[str, torch.Tensor],
                ix: Dict[str, torch.Tensor], k: Dict[str, torch.Tensor],
                banks_w: torch.Tensor, banks_a: torch.Tensor,
                rows: torch.Tensor) -> torch.Tensor:
        """Eq. (1)-(8) latency tail on the screen-surviving `rows`; `ix`
        holds every config's table rows (`_table_rows`)."""
        f64 = torch.float64
        g = {name: dv[name][i[rows]] for name, i in ix.items()
             if name != "atile_tbl"}
        batch_iters, pb = split_rows(g["pb_tbl"], 2)
        cd_if, pif = split_rows(g["ifp_tbl"], 2)
        cd_of, pof = split_rows(g["ofp_tbl"], 2)
        cd_ox, pox = split_rows(g["xp_tbl"], 2)
        cd_oy, poy = split_rows(g["yp_tbl"], 2)
        cd_kk, p_kxky = split_rows(g["kk_tbl"], 2)
        chan_tiles, _, ofm_tiles = split_rows(g["wt_tbl"], 3)
        spatial_tiles = g["spatial_tbl"]

        # Eq. (3): Tkx=Nkx / Tky=Nky make the kernel factors exactly 1
        inter = chan_tiles * spatial_tiles
        inner = cd_if * cd_kk * cd_ox * cd_oy * cd_of
        compute_cycles = inter * inner * batch_iters * dv["repeat"]

        poxy = pox * poy
        weight_reuse = poxy * pb                                # Eq. (1)
        in_win = g["win_x_tbl"] * g["win_y_tbl"]
        input_reuse = torch.clamp(
            (pof * p_kxky * poxy) // torch.clamp(in_win, min=1),
            min=1)                                              # Eq. (2)

        # loop-order dataflows: each element takes its row's branch
        lo = k["loop_order"][rows][:, None]
        ws_in = (dv["ie_batch"] * ofm_tiles).to(f64)
        osis_w = (dv["weight_elems"] * spatial_tiles).to(f64)
        num_weight_eff = torch.where(
            lo == int(LoopOrder.PAPER),
            dv["num_weight"] / torch.clamp(weight_reuse, min=1),
            torch.where(lo == int(LoopOrder.WEIGHT_STATIONARY),
                        dv["ws_weight"], osis_w))
        num_input_eff = torch.where(
            lo == int(LoopOrder.PAPER),
            dv["num_input"] / torch.clamp(input_reuse, min=1),
            torch.where(lo == int(LoopOrder.INPUT_STATIONARY),
                        dv["is_input"], ws_in))

        bit_width = int(self.hw.bit_width)
        wbw = torch.clamp(banks_w[rows] // bit_width, min=1)[:, None]
        abw = torch.clamp(banks_a[rows] // bit_width, min=1)[:, None]
        weight_cycles = torch.ceil(num_weight_eff / wbw)        # Eq. (7)
        input_cycles = torch.ceil(num_input_eff / abw)          # Eq. (8)
        total = torch.maximum(compute_cycles.to(f64),
                              torch.maximum(weight_cycles, input_cycles))
        # restore the repeated op columns, then sum them in numpy's order
        return numpy_order_sum(total.t()[dv["expand"]].contiguous())
