"""Analytical hardware cost model for DNN operations (paper §3), the
PyTorch port's own copy.

It holds the Table-1 operation embeddings (`Op`, `OpStream`), the design
point (`AccelConfig`, `ConfigBatch`), the unit-area model (`area_many`),
the per-(stream, hw, value-set) gather tables (`_FusedTables`, numpy on
the host, put on a device by `DeviceTables` for the fused scorer
`repro_torch.kernels.costmodel.FusedTorchScorer` and the table pass) and
the analysis API:

  * `evaluate_stream_many` — Eqs. (1)-(13) over a `[C, O]` (configs x
    ops) grid.  ``backend="tables"`` (the default) takes the table pass
    for pools of at least `_TABLES_MIN_POOL` configs on a stream with no
    zero-size kernel or stride: it costs the stream's unique op columns,
    fetching each config's rows of the tables with `gather_rows`; other
    inputs take the broadcast pass.  ``backend="broadcast"`` runs the
    broadcast formulas on a torch device in int64/float64, row chunk by
    row chunk; ``backend="numpy-ref"`` is the verbatim host formulas, the
    oracle both device passes equal bit for bit;
  * `evaluate_stream` (one config, per-op `LatencyBreakdown`),
    `performance_gops` (GOPS per config) and the block-level
    `BufferSimulator`.

Conventions:
  * all memory quantities in **bits** unless suffixed `_bytes`
  * `S` is the sliding stride; `batch` the input batch size
  * an operation is the canonical 9-tuple of loop bounds
    (Nif, Nix, Niy, Nkx, Nky, Nof, Nox, Noy, S) plus `batch`
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.kernels.gather import gather_rows

__all__ = [
    "OpKind",
    "Op",
    "OpStream",
    "HardwareConstants",
    "LoopOrder",
    "AccelConfig",
    "ConfigBatch",
    "LatencyBreakdown",
    "evaluate_stream",
    "evaluate_stream_many",
    "area_many",
    "performance_gops",
    "BufferSimulator",
    "numpy_order_sum",
    "resolve_device",
    "DeviceTables",
    "PASSES",
]


class OpKind(enum.Enum):
    """DNN operation kinds covered by the cost model (paper Table 1)."""

    CONV2D = "conv2d"
    DEPTHWISE_CONV = "depthwise_conv"
    CHANNEL_MIXING = "channel_mixing"
    MATVEC = "matvec"
    MATMUL = "matmul"


@dataclasses.dataclass(frozen=True)
class Op:
    """One DNN operation in canonical 2-D-convolution coordinates.

    The Table 1 embeddings are provided as constructors so that every
    compute-intensive op is expressed in the *same* 9 loop bounds and can be
    costed by one model.
    """

    kind: OpKind
    nif: int
    nix: int
    niy: int
    nkx: int
    nky: int
    nof: int
    nox: int
    noy: int
    s: int = 1
    batch: int = 1
    name: str = ""
    # Number of *logical* instances this canonical op stands for.  Depthwise
    # convolution is embedded with Nof=1 (paper Table 1) and therefore
    # repeats once per channel: repeat = Nif of the original depthwise layer.
    repeat: int = 1

    # ---------------------------------------------------------- constructors
    @staticmethod
    def conv2d(nif: int, nix: int, niy: int, nkx: int, nky: int, nof: int,
               s: int = 1, batch: int = 1, name: str = "") -> "Op":
        nox = (nix - nkx) // s + 1
        noy = (niy - nky) // s + 1
        return Op(OpKind.CONV2D, nif, nix, niy, nkx, nky, nof,
                  max(nox, 1), max(noy, 1), s, batch, name)

    @staticmethod
    def depthwise(nif: int, nix: int, niy: int, nkx: int, nky: int,
                  s: int = 1, batch: int = 1, name: str = "") -> "Op":
        """Depthwise conv == 2-D conv with #filter kernels = 1 (Table 1 row 2).

        The single-channel convolution repeats across the `nif` channels; we
        keep `repeat = nif` and cost a per-channel op with Nif = 1 so the
        arithmetic matches a true depthwise layer.
        """
        nox = (nix - nkx) // s + 1
        noy = (niy - nky) // s + 1
        return Op(OpKind.DEPTHWISE_CONV, 1, nix, niy, nkx, nky, 1,
                  max(nox, 1), max(noy, 1), s, batch, name, repeat=nif)

    @staticmethod
    def channel_mixing(nif: int, nix: int, niy: int, nof: int,
                       s: int = 1, batch: int = 1, name: str = "") -> "Op":
        """1x1 convolution across channels (Table 1 row 3)."""
        nox = (nix - 1) // s + 1
        noy = (niy - 1) // s + 1
        return Op(OpKind.CHANNEL_MIXING, nif, nix, niy, 1, 1, nof,
                  nox, noy, s, batch, name)

    @staticmethod
    def matvec(col: int, row: int, batch: int = 1, name: str = "") -> "Op":
        """Matrix-vector multiply (Table 1 row 4).

        Nif=col, Nix=row, Niy=1, Nkx=Nky=1, Nof=1, Nox=row, Noy=1, S=1.
        """
        return Op(OpKind.MATVEC, col, row, 1, 1, 1, 1, row, 1, 1, batch, name)

    @staticmethod
    def matmul(col1: int, row1: int, col2: int, batch: int = 1,
               name: str = "") -> "Op":
        """Matrix-matrix multiply (Table 1 row 5).

        [row1 x col1] @ [col1 x col2]:
        Nif=col_1, Nix=row_1, Niy=1, Nkx=Nky=1, Nof=col_2, Nox=row_1, Noy=1.
        """
        return Op(OpKind.MATMUL, col1, row1, 1, 1, 1, col2, row1, 1, 1,
                  batch, name)

    @staticmethod
    def batched_matmul(col1: int, row1: int, col2: int, instances: int = 1,
                       batch: int = 1, name: str = "") -> "Op":
        """Table 1 row 5 repeated `instances` times with *distinct* data.

        This is the embedding for batched contractions whose leading
        dimensions index independent problem instances — attention heads
        (scores/values are one matmul per head) and MoE experts (one expert
        GEMM per expert) — via the same `repeat` mechanism the depthwise
        embedding uses.  `batch` remains the input-batch dimension that the
        Pb unrolling of Fig. 2(e) exploits.
        """
        return Op(OpKind.MATMUL, col1, row1, 1, 1, 1, col2, row1, 1, 1,
                  batch, name, repeat=instances)

    @staticmethod
    def batched_matvec(col: int, row: int, instances: int = 1,
                       batch: int = 1, name: str = "") -> "Op":
        """Table 1 row 4 repeated `instances` times (e.g. per-head decode
        attention where the single query row multiplies each head's KV)."""
        return Op(OpKind.MATVEC, col, row, 1, 1, 1, 1, row, 1, 1, batch,
                  name, repeat=instances)

    # ------------------------------------------------------------ properties
    @property
    def macs(self) -> int:
        """N_MAC = Nif x Nkx x Nky x Nox x Noy x Nof (per batch element)."""
        return (self.nif * self.nkx * self.nky * self.nox * self.noy
                * self.nof * self.repeat)

    @property
    def weight_elems(self) -> int:
        return self.nif * self.nkx * self.nky * self.nof * self.repeat

    @property
    def input_elems(self) -> int:
        return self.nif * self.nix * self.niy * self.repeat

    @property
    def output_elems(self) -> int:
        return self.nof * self.nox * self.noy * self.repeat


class OpStream:
    """Struct-of-arrays view over a sequence of `Op`s for vectorized costing."""

    FIELDS = ("nif", "nix", "niy", "nkx", "nky", "nof", "nox", "noy", "s",
              "batch", "repeat")

    def __init__(self, ops: Sequence[Op]):
        self.ops = list(ops)
        n = len(self.ops)
        for f in self.FIELDS:
            setattr(self, f,
                    np.asarray([getattr(op, f) for op in self.ops],
                               dtype=np.int64).reshape(1, n))
        # Table-1 element counts are loop-invariant across every config the
        # engines score against this stream — precompute once.
        self._weight_elems = (self.nif * self.nkx * self.nky * self.nof
                              * self.repeat)
        self._input_elems = self.nif * self.nix * self.niy * self.repeat
        # [len(FIELDS), O] row-stacked field matrix for array backends
        self._field_matrix: Optional[np.ndarray] = None
        self._dedup: Optional[Tuple["OpStream", np.ndarray]] = None

    def __len__(self) -> int:
        return len(self.ops)

    def dedup_columns(self) -> Tuple["OpStream", np.ndarray]:
        """(unique-column view, expand) — repeated layers appear as repeated
        op columns (transformer blocks, ResNet stages), so kernels can cost
        the unique columns only; ``view_result[:, expand]`` restores the
        original [*, O] layout (``original == view.field_matrix[:, expand]``
        column-exactly).  Cached on the stream."""
        if self._dedup is None:
            uniq, first, inv = np.unique(self.field_matrix, axis=1,
                                         return_index=True,
                                         return_inverse=True)
            view = OpStream([self.ops[int(i)] for i in first])
            self._dedup = (view, np.asarray(inv, dtype=np.int64).ravel())
        return self._dedup

    def weight_elems_arr(self) -> np.ndarray:
        """[1, O] weight element counts (Table 1), precomputed."""
        return self._weight_elems

    def input_elems_arr(self) -> np.ndarray:
        """[1, O] input element counts (Table 1), precomputed."""
        return self._input_elems

    @property
    def field_matrix(self) -> np.ndarray:
        """[len(FIELDS), O] int64 matrix (row j = FIELDS[j]), lazily built
        (`dedup_columns` finds repeated op columns on it)."""
        if self._field_matrix is None:
            self._field_matrix = np.concatenate(
                [getattr(self, f) for f in self.FIELDS], axis=0)
        return self._field_matrix

    @property
    def total_macs(self) -> int:
        return int(sum(op.macs * op.batch for op in self.ops))

    @property
    def total_ops(self) -> int:
        """Total arithmetic operations (1 MAC = 2 ops)."""
        return 2 * self.total_macs


@dataclasses.dataclass(frozen=True)
class HardwareConstants:
    """Technology constants for the unit-area model and timing (paper §4.3)."""

    frequency_hz: float = 1.0e9          # accelerator clock
    bit_width: int = 8                   # quantized datapath (cf. [7])
    # unit-area model: "unit area for each component ... scaled according to
    # the architectural configuration"
    area_per_mac: float = 1.0
    # 28 nm: an 8-bit MAC ~ 700 um^2, 6T SRAM ~ 0.12 um^2/bit -> ~1.7e-4
    area_per_sram_bit: float = 1.7e-4
    area_per_group_ctrl: float = 8.0
    area_per_mac_regfile: float = 0.2
    # off-chip transfer setup latency charged per computational block by the
    # optional buffer simulator (cycles)
    offchip_burst_setup: int = 64
    offchip_words_per_cycle: int = 16


# Loop-order dataflows (Table 2 `loop_order`).  The execution order of the
# six convolution loops determines how often tiles are *re*-fetched from
# off-chip memory (cf. Ma et al. [1] §4).  We expose the four canonical
# orders; `PAPER` is the order the paper's Eqs. (5)-(8) assume (each weight /
# input word is fetched once per use and discounted by the reuse factors).
class LoopOrder(enum.IntEnum):
    PAPER = 0              # Eqs. (5)-(8) verbatim
    WEIGHT_STATIONARY = 1  # weight tiles resident; inputs streamed per tile
    OUTPUT_STATIONARY = 2  # output tile resident; inputs+weights streamed
    INPUT_STATIONARY = 3   # input tiles resident; weights streamed per tile


@dataclasses.dataclass(frozen=True)
class AccelConfig:
    """One point in the accelerator design space (paper Table 2 + §2.2 P*).

    Design variables:
      loop_order            execution order of the convolution loops
      pe_group              number of PE groups
      mac_per_group         MACs per PE group
      bank_height           buffer bank height (words)
      bank_width            buffer bank width (bits)
      weight_banks_pg       weight buffer banks per PE group
      act_banks_pg          activation buffer banks per PE group
      tif, tix, tiy, tof    loop-tiling sizes (Table 2)
      pif, pof, pox, poy    loop-unrolling factors (§2.2, Fig. 2)
      pkx, pky              kernel-window unrolling factors
      pb                    batch unrolling factor (Fig. 2(e))
    """

    loop_order: int = LoopOrder.PAPER
    pe_group: int = 8
    mac_per_group: int = 64
    bank_height: int = 1024
    bank_width: int = 64
    weight_banks_pg: int = 4
    act_banks_pg: int = 4
    tif: int = 64
    tix: int = 32
    tiy: int = 32
    tof: int = 64
    pif: int = 8
    pof: int = 8
    pox: int = 2
    poy: int = 2
    pkx: int = 1
    pky: int = 1
    pb: int = 1

    # ------------------------------------------------------------- derived
    @property
    def total_macs(self) -> int:
        return self.pe_group * self.mac_per_group

    def weight_buffer_bits(self) -> int:
        return self.weight_banks_pg * self.pe_group * self.bank_height * \
            self.bank_width

    def act_buffer_bits(self) -> int:
        return self.act_banks_pg * self.pe_group * self.bank_height * \
            self.bank_width

    def weight_bandwidth(self, hw: HardwareConstants) -> int:
        """On-chip weight words deliverable per cycle."""
        return max(1, self.weight_banks_pg * self.pe_group * self.bank_width
                   // hw.bit_width)

    def input_bandwidth(self, hw: HardwareConstants) -> int:
        return max(1, self.act_banks_pg * self.pe_group * self.bank_width
                   // hw.bit_width)

    def area(self, hw: HardwareConstants) -> float:
        """Unit-area model (paper §4.3)."""
        sram_bits = self.weight_buffer_bits() + self.act_buffer_bits()
        return (self.total_macs * (hw.area_per_mac + hw.area_per_mac_regfile)
                + sram_bits * hw.area_per_sram_bit
                + self.pe_group * hw.area_per_group_ctrl)

    def asdict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


# Canonical field order for every array view of the design space.  Cache
# keys, ConfigBatch matrices, and the broadcast kernels all follow it.
_CFG_FIELDS = ("loop_order", "pe_group", "mac_per_group", "bank_height",
               "bank_width", "weight_banks_pg", "act_banks_pg",
               "tif", "tix", "tiy", "tof",
               "pif", "pof", "pox", "poy", "pkx", "pky", "pb")

_CFG_DEFAULTS = {f.name: int(f.default)
                 for f in dataclasses.fields(AccelConfig)}


class ConfigBatch:
    """Struct-of-arrays view over N accelerator configurations.

    One `[N]` int64 column per `AccelConfig` field, stored as a contiguous
    `[N, len(FIELDS)]` matrix in canonical `_CFG_FIELDS` order.  This is the
    array-native currency of the evaluation pipeline: search engines build
    it straight from `SpaceCodec` index arrays (no dataclass
    materialization), `area_many` and the fused scorer consume it
    directly, and the `Evaluator` keys its cache on the raw matrix rows.
    `AccelConfig` remains the scalar / reporting view: `batch[i]` and
    `batch.to_configs()` materialize dataclasses on demand.
    """

    FIELDS = _CFG_FIELDS
    _INDEX = {f: j for j, f in enumerate(_CFG_FIELDS)}

    __slots__ = ("matrix",)

    def __init__(self, matrix: np.ndarray):
        m = np.ascontiguousarray(matrix, dtype=np.int64)
        if m.ndim != 2 or m.shape[1] != len(self.FIELDS):
            raise ValueError(f"expected [N, {len(self.FIELDS)}] matrix, "
                             f"got shape {m.shape}")
        self.matrix = m

    # ---------------------------------------------------------- constructors
    @classmethod
    def from_configs(cls, configs: "Sequence[AccelConfig] | ConfigBatch"
                     ) -> "ConfigBatch":
        """Batch view of dataclass configs (identity on a ConfigBatch)."""
        if isinstance(configs, cls):
            return configs
        configs = list(configs)
        m = np.empty((len(configs), len(cls.FIELDS)), dtype=np.int64)
        for j, f in enumerate(cls.FIELDS):
            m[:, j] = [getattr(c, f) for c in configs]
        return cls(m)

    @classmethod
    def from_columns(cls, **cols: np.ndarray) -> "ConfigBatch":
        """Build from named `[N]` field arrays; missing fields take the
        `AccelConfig` defaults, scalars broadcast."""
        unknown = set(cols) - set(cls.FIELDS)
        if unknown:
            raise ValueError(f"unknown AccelConfig fields: {sorted(unknown)}")
        n = max((np.asarray(v).size for v in cols.values()), default=1)
        m = np.empty((n, len(cls.FIELDS)), dtype=np.int64)
        for j, f in enumerate(cls.FIELDS):
            m[:, j] = np.asarray(cols.get(f, _CFG_DEFAULTS[f]),
                                 dtype=np.int64)
        return cls(m)

    @classmethod
    def concat(cls, batches: Sequence["ConfigBatch"]) -> "ConfigBatch":
        return cls(np.vstack([b.matrix for b in batches]))

    # -------------------------------------------------------------- accessors
    def col(self, name: str) -> np.ndarray:
        """[N] view of one field column."""
        return self.matrix[:, self._INDEX[name]]

    def __len__(self) -> int:
        return self.matrix.shape[0]

    def __getitem__(self, i):
        if isinstance(i, (int, np.integer)):
            row = self.matrix[i]
            return AccelConfig(**{f: int(row[j])
                                  for j, f in enumerate(self.FIELDS)})
        return ConfigBatch(self.matrix[i])

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def take(self, rows: np.ndarray) -> "ConfigBatch":
        return ConfigBatch(self.matrix[np.asarray(rows, dtype=np.int64)])

    def to_configs(self) -> List[AccelConfig]:
        """Materialize the scalar/reporting view (one dataclass per row)."""
        return [self[i] for i in range(len(self))]

    def row_keys(self) -> List[bytes]:
        """Stable per-row hashable identity: the raw bytes of each canonical
        field row — the vectorized replacement for per-config
        `config_key` dict sorting."""
        return [r.tobytes() for r in self.matrix]

    # ---------------------------------------------------------- derived arrays
    def total_macs_arr(self) -> np.ndarray:
        return self.col("pe_group") * self.col("mac_per_group")

    def weight_buffer_bits_arr(self) -> np.ndarray:
        return (self.col("weight_banks_pg") * self.col("pe_group")
                * self.col("bank_height") * self.col("bank_width"))

    def act_buffer_bits_arr(self) -> np.ndarray:
        return (self.col("act_banks_pg") * self.col("pe_group")
                * self.col("bank_height") * self.col("bank_width"))


def area_many(configs: "Sequence[AccelConfig] | ConfigBatch",
              hw: HardwareConstants = HardwareConstants(),
              device=None) -> np.ndarray:
    """Vectorized unit-area model (paper §4.3): `[N]` float64 areas, equal
    bit-for-bit to `[c.area(hw) for c in configs]`.  With a `device` the
    polynomial runs there (`_area_t`), to the same bits."""
    b = ConfigBatch.from_configs(configs)
    if device is not None:
        m = torch.from_numpy(b.matrix).to(resolve_device(device))
        col = {f: m[:, j] for j, f in enumerate(ConfigBatch.FIELDS)}
        pe_group = col["pe_group"]
        sram_bits = ((col["weight_banks_pg"] * pe_group * col["bank_height"]
                      * col["bank_width"])
                     + (col["act_banks_pg"] * pe_group * col["bank_height"]
                        * col["bank_width"]))
        return _area_t(pe_group, pe_group * col["mac_per_group"], sram_bits,
                       hw).cpu().numpy()
    sram_bits = b.weight_buffer_bits_arr() + b.act_buffer_bits_arr()
    return (b.total_macs_arr() * (hw.area_per_mac + hw.area_per_mac_regfile)
            + sram_bits * hw.area_per_sram_bit
            + b.col("pe_group") * hw.area_per_group_ctrl)


def _area_t(pe_group: torch.Tensor, total_macs: torch.Tensor,
            sram_bits: torch.Tensor, hw: HardwareConstants) -> torch.Tensor:
    """`area_many`'s polynomial on int64 tensors, in its operand order.  An
    int64 tensor times a Python float is float32 in torch, so each term is
    converted to float64 first, as numpy does."""
    f64 = torch.float64
    return (total_macs.to(f64) * (hw.area_per_mac + hw.area_per_mac_regfile)
            + sram_bits.to(f64) * hw.area_per_sram_bit
            + pe_group.to(f64) * hw.area_per_group_ctrl)


def resolve_device(device) -> torch.device:
    """`torch.device(device)`, refusing a CUDA device that is not there
    (the port never carries on silently on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return dev


def numpy_order_sum(x: torch.Tensor) -> torch.Tensor:
    """Sums over dim 0 of `x` ([n, R] -> [R]) in the order numpy's
    `np.add.reduce` adds a contiguous float64 row: the identity 0.0 plus
    the pairwise sum of the row (8 running partial sums for 8 <= n <= 128,
    halving at multiples of 8 above).  Float addition is not associative,
    so this order is what makes the per-config cycle totals bit-identical
    to the numpy scorer; `torch.sum` keeps no particular order."""
    return _pairwise(x, 0, x.shape[0]) + 0.0


def _pairwise(x: torch.Tensor, lo: int, n: int) -> torch.Tensor:
    if n < 8:
        res = torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
        for i in range(lo, lo + n):
            res = res + x[i]
        return res
    if n <= 128:
        r = x[lo:lo + 8].clone()
        i = 8
        while i < n - n % 8:
            r += x[lo + i:lo + i + 8]
            i += 8
        res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5])
                                                 + (r[6] + r[7]))
        for j in range(lo + i, lo + n):
            res = res + x[j]
        return res
    n2 = n // 2
    n2 -= n2 % 8
    return _pairwise(x, lo, n2) + _pairwise(x, lo + n2, n - n2)


def _ceil_div(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return -(-a // np.maximum(b, 1))


# --------------------------------------------------------------------------
# Fused scoring tables.  Every expensive [C, O] term of Eqs. (1)-(13)
# depends on the configuration only through one to four small-domain
# fields, so it is computed once per unique field value (or value tuple) as
# a [U, O] int64 table; the scorer gathers rows of these tables by per-row
# codes.  All entries come from the exact reference expressions, so the
# gathered values are bit-identical to computing the formulas per element.
# --------------------------------------------------------------------------

_FAST_FIELDS = ("tif", "tix", "tiy", "tof", "pif", "pof", "pox", "poy",
                "pkx", "pky", "pb")


# value->code lookup arrays are dense over [0, max_value]; fields with
# absurdly large values (hand-built configs, not space-sampled ones) fall
# back to np.searchsorted coding rather than allocating huge LUTs
_FUSED_LUT_MAX = 1 << 22


class _FusedTables:
    """Shared per-(stream, hw, value-set) gather tables for the fused path.

    Instances are cached in `_FUSED_TABLE_CACHE` keyed by the stream object
    (weakly) + hw constants + the field-value sets, so every Evaluator on
    the same (app, space) in the process reuses one table build.
    """

    def __init__(self, stream: OpStream, hw: HardwareConstants,
                 values: Dict[str, np.ndarray]):
        self.stream = stream
        self.hw = hw
        self.ops, self.expand = stream.dedup_columns()
        self.values = {f: np.asarray(sorted(set(values[f].tolist())),
                                     dtype=np.int64)
                       for f in _FAST_FIELDS}
        self.n_rebuilds = 0
        self._build()

    # ------------------------------------------------------------- building
    def _build(self) -> None:
        o, hw = self.ops, self.hw
        v = self.values
        self.nvals = {f: len(v[f]) for f in _FAST_FIELDS}
        self.luts: Dict[str, Optional[np.ndarray]] = {}
        for f in _FAST_FIELDS:
            top = int(v[f][-1]) if len(v[f]) else 0
            lo = int(v[f][0]) if len(v[f]) else 0
            if 0 <= lo and top <= _FUSED_LUT_MAX:
                lut = np.full(top + 2, -1, dtype=np.int64)
                lut[v[f]] = np.arange(len(v[f]), dtype=np.int64)
                self.luts[f] = lut
            else:                      # degenerate values: searchsorted path
                self.luts[f] = None

        def col(vals: np.ndarray) -> np.ndarray:
            return vals[:, None]

        def tox_of(tix_vals: np.ndarray) -> np.ndarray:
            return np.clip(
                (np.minimum(col(tix_vals), o.nix) - o.nkx) // o.s + 1,
                1, o.nox)

        def toy_of(tiy_vals: np.ndarray) -> np.ndarray:
            return np.clip(
                (np.minimum(col(tiy_vals), o.niy) - o.nky) // o.s + 1,
                1, o.noy)

        def grid(*fields: str) -> List[np.ndarray]:
            """Domain-complete value grids: one flat [prod(U_f)] array per
            field, row-major over the field order (matching `_code`)."""
            sizes = [self.nvals[f] for f in fields]
            out = []
            for k, f in enumerate(fields):
                reps_in = int(np.prod(sizes[k + 1:], dtype=np.int64))
                reps_out = int(np.prod(sizes[:k], dtype=np.int64))
                out.append(np.tile(np.repeat(v[f], reps_in), reps_out))
            return out

        # -- base pair/triple tables (verbatim fast-path expressions) --
        p_b = np.minimum(col(v["pb"]), o.batch)
        self.pb_tbl = np.stack([_ceil_div(o.batch, p_b), p_b])

        tif_u, pif_u = grid("tif", "pif")
        tmp = np.minimum(col(tif_u), o.nif)
        p_if = np.minimum(col(pif_u), tmp)
        self.ifp_tbl = np.stack([_ceil_div(tmp, p_if), p_if])

        tof_u, pof_u = grid("tof", "pof")
        tmp = np.minimum(col(tof_u), o.nof)
        p_of = np.minimum(col(pof_u), tmp)
        self.ofp_tbl = np.stack([_ceil_div(tmp, p_of), p_of])

        tix_u, pox_u = grid("tix", "pox")
        tmp = tox_of(tix_u)
        p_ox = np.minimum(col(pox_u), tmp)
        self.xp_tbl = np.stack([_ceil_div(tmp, p_ox), p_ox])

        tiy_u, poy_u = grid("tiy", "poy")
        tmp = toy_of(tiy_u)
        p_oy = np.minimum(col(poy_u), tmp)
        self.yp_tbl = np.stack([_ceil_div(tmp, p_oy), p_oy])

        pkx_u, pky_u = grid("pkx", "pky")
        p_kx = np.minimum(col(pkx_u), o.nkx)
        p_ky = np.minimum(col(pky_u), o.nky)
        self.kk_tbl = np.stack(
            [_ceil_div(o.nkx, p_kx) * _ceil_div(o.nky, p_ky), p_kx * p_ky])

        tix_w, pox_w, pkx_w = grid("tix", "pox", "pkx")
        self.win_x_tbl = ((np.minimum(col(pox_w), tox_of(tix_w)) - 1) * o.s
                          + np.minimum(col(pkx_w), o.nkx))
        tiy_w, poy_w, pky_w = grid("tiy", "poy", "pky")
        self.win_y_tbl = ((np.minimum(col(poy_w), toy_of(tiy_w)) - 1) * o.s
                          + np.minimum(col(pky_w), o.nky))

        tif_w, tof_w = grid("tif", "tof")
        t_if = np.minimum(col(tif_w), o.nif)
        t_of = np.minimum(col(tof_w), o.nof)
        self.wt_tbl = np.stack([
            _ceil_div(o.nif, t_if) * _ceil_div(o.nof, t_of),
            o.nkx * o.nky * t_if * t_of * hw.bit_width,      # Eq. (10), bits
            _ceil_div(o.nof, t_of),
        ])

        tix_s, tiy_s = grid("tix", "tiy")
        self.spatial_tbl = (_ceil_div(o.nox, tox_of(tix_s))
                            * _ceil_div(o.noy, toy_of(tiy_s)))

        # -- joint unroll-product tables for the validity screen (int64
        # products are exact mod 2^64, so folding is bit-preserving) --
        tif_1, pif_1, pkx_1, pky_1 = grid("tif", "pif", "pkx", "pky")
        self.u1_tbl = (np.minimum(col(pif_1),
                                  np.minimum(col(tif_1), o.nif))
                       * np.minimum(col(pkx_1), o.nkx)
                       * np.minimum(col(pky_1), o.nky))      # pif * pkx*pky
        tix_2, pox_2, tiy_2, poy_2 = grid("tix", "pox", "tiy", "poy")
        self.u2_tbl = (np.minimum(col(pox_2), tox_of(tix_2))
                       * np.minimum(col(poy_2), toy_of(tiy_2)))  # pox * poy
        tof_3, pof_3, pb_3 = grid("tof", "pof", "pb")
        self.u3_tbl = (np.minimum(col(pof_3),
                                  np.minimum(col(tof_3), o.nof))
                       * np.minimum(col(pb_3), o.batch))     # pof * pb

        # -- Eq. (12) activation-tile table, joint over all four fields --
        tix_a, tiy_a, tif_a, tof_a = grid("tix", "tiy", "tif", "tof")
        self.atile_tbl = ((np.minimum(col(tix_a), o.nix)
                           * np.minimum(col(tiy_a), o.niy)
                           * np.minimum(col(tif_a), o.nif)
                           + tox_of(tix_a) * toy_of(tiy_a)
                           * np.minimum(col(tof_a), o.nof))
                          * hw.bit_width)                    # bits

        # -- op-only constants hoisted for the latency tail --
        self.num_weight = (o.nox * o.noy * o.nkx * o.nky * o.nif * o.nof
                           * o.repeat).astype(np.float64)    # Eq. (5)
        self.num_input = self.num_weight * o.batch           # Eq. (6)
        self.ws_weight = o.weight_elems_arr() * 1.0
        self.ie_batch = o.input_elems_arr() * o.batch
        self.is_input = o.input_elems_arr() * o.batch * 1.0
        self.weight_elems = o.weight_elems_arr()
        self.repeat = o.repeat
        self.max_batch = int(o.batch.max())
        self.total_ops = self.stream.total_ops

    # -------------------------------------------------------------- coding
    def _code_field(self, f: str, vals: np.ndarray) -> Optional[np.ndarray]:
        """[C] value -> table index for one field; None on unseen values."""
        lut = self.luts[f]
        if lut is not None:
            if vals.size and (int(vals.max()) >= lut.shape[0]
                              or int(vals.min()) < 0):
                return None
            code = lut[vals]
            if vals.size and int(code.min()) < 0:
                return None
            return code
        dom = self.values[f]
        code = np.searchsorted(dom, vals)
        code_c = np.minimum(code, len(dom) - 1)
        if vals.size and not bool((dom[code_c] == vals).all()):
            return None
        return code_c

    def codes(self, matrix: np.ndarray) -> Dict[str, np.ndarray]:
        """Per-field table indices for every row, growing the value sets
        (and rebuilding the tables) when a pool brings unseen values."""
        out: Dict[str, np.ndarray] = {}
        grown = False
        for f in _FAST_FIELDS:
            vals = matrix[:, ConfigBatch._INDEX[f]]
            code = self._code_field(f, vals)
            if code is None:
                merged = np.union1d(self.values[f], np.unique(vals))
                self.values[f] = merged.astype(np.int64)
                grown = True
                continue
            out[f] = code
        if grown:
            self.n_rebuilds += 1
            self._build()
            return self.codes(matrix)
        return out


# stream (weak) -> {(hw fingerprint, value-set fingerprint): _FusedTables}
_FUSED_TABLE_CACHE: ("weakref.WeakKeyDictionary[OpStream, "
                     "Dict[Tuple, _FusedTables]]") = \
    weakref.WeakKeyDictionary()


def _fused_tables_for(stream: OpStream, hw: HardwareConstants,
                      domains: Optional[Dict[str, Sequence[int]]]
                      ) -> _FusedTables:
    per_stream = _FUSED_TABLE_CACHE.setdefault(stream, {})
    hw_key = (int(hw.bit_width), float(hw.frequency_hz))
    if domains is not None:
        dom_key = tuple((f, tuple(sorted(domains[f])))
                        for f in _FAST_FIELDS if f in domains)
    else:
        dom_key = None
    key = (hw_key, dom_key)
    tables = per_stream.get(key)
    if tables is None:
        values = {}
        for f in _FAST_FIELDS:
            if domains is not None and f in domains:
                values[f] = np.asarray(sorted(domains[f]), dtype=np.int64)
            else:
                values[f] = np.asarray([_CFG_DEFAULTS[f]], dtype=np.int64)
        tables = _FusedTables(stream, hw, values)
        per_stream[key] = tables
    return tables


# `_FusedTables` arrays the device passes read.  The stacked [k, U, O]
# tables go to the device as [U, k * O], so one gather of a row fetches
# all k tables of its index.
_DEVICE_ARRAYS = ("pb_tbl", "ifp_tbl", "ofp_tbl", "xp_tbl", "yp_tbl",
                  "kk_tbl", "win_x_tbl", "win_y_tbl", "wt_tbl",
                  "spatial_tbl", "u1_tbl", "u2_tbl", "u3_tbl", "atile_tbl",
                  "num_weight", "num_input", "ws_weight", "ie_batch",
                  "is_input", "weight_elems", "repeat", "expand")
_STACKED = ("pb_tbl", "ifp_tbl", "ofp_tbl", "xp_tbl", "yp_tbl", "kk_tbl",
            "wt_tbl")


def split_rows(g: torch.Tensor, k: int) -> Tuple[torch.Tensor, ...]:
    """The k [R, O] tables of gathered [R, k * O] rows of a stacked table."""
    return g.unflatten(1, (k, -1)).unbind(1)


class DeviceTables:
    """One `_FusedTables` on a torch device, uploaded again after a pool
    with unseen values rebuilt it; `n_uploads` counts the uploads.  The
    fused scorer and the table pass each keep their own."""

    def __init__(self, tables: _FusedTables, device: torch.device):
        self.tables = tables
        self.device = device
        self.n_uploads = 0
        self._rebuilds = -1
        self._dev: Dict[str, torch.Tensor] = {}

    def get(self) -> Dict[str, torch.Tensor]:
        t = self.tables
        if self._rebuilds != t.n_rebuilds:
            def up(a: np.ndarray) -> torch.Tensor:
                return torch.from_numpy(np.ascontiguousarray(a)).to(
                    self.device)

            self._dev = {}
            for name in _DEVICE_ARRAYS:
                a = getattr(t, name)
                if name in _STACKED:
                    a = a.transpose(1, 0, 2).reshape(a.shape[1], -1)
                self._dev[name] = up(a)
            # the Eq. (10) weight tile on its own, the screen's operand
            self._dev["wt_tile"] = up(t.wt_tbl[1])
            self._rebuilds = t.n_rebuilds
            self.n_uploads += 1
        return self._dev


# _FusedTables (weak) -> {device: DeviceTables} of the table pass
_TABLE_PASS_UPLOADS: ("weakref.WeakKeyDictionary[_FusedTables, "
                      "Dict[str, DeviceTables]]") = \
    weakref.WeakKeyDictionary()


# --------------------------------------------------------------------------
# The analysis API: Eqs. (1)-(13) broadcast over [C, O].  `cfg_arrays` maps
# each AccelConfig field to an int64 column of shape [C, 1]; the op stream
# contributes row vectors of shape [1, O].
# --------------------------------------------------------------------------


@dataclasses.dataclass
class LatencyBreakdown:
    """Per-stream latency decomposition (cycles)."""

    compute_cycles: np.ndarray        # [ops]
    weight_cycles: np.ndarray         # [ops]
    input_cycles: np.ndarray          # [ops]
    total_cycles: np.ndarray          # [ops] max(compute, memory)
    valid: np.ndarray                 # [ops] Eq. 9-13 satisfied

    @property
    def stream_cycles(self) -> float:
        return float(self.total_cycles.sum())

    @property
    def stream_valid(self) -> bool:
        return bool(self.valid.all())

    def latency_shares(self) -> np.ndarray:
        """[ops] fraction of the stream's total latency each op carries."""
        total = float(self.total_cycles.sum())
        if total <= 0:
            return np.zeros_like(np.asarray(self.total_cycles,
                                            dtype=np.float64))
        return np.asarray(self.total_cycles, dtype=np.float64) / total

    def bottlenecks(self) -> List[str]:
        """Per-op bottleneck resource under the max(compute, weight,
        input) latency model.  Ties resolve compute > weight > input so
        the label is deterministic (a perfectly balanced op reads as
        compute-bound, matching the paper's Table-1 framing)."""
        out: List[str] = []
        for c, w, i in zip(self.compute_cycles, self.weight_cycles,
                           self.input_cycles):
            if c >= w and c >= i:
                out.append("compute")
            elif w >= i:
                out.append("weight")
            else:
                out.append("input")
        return out


def _configs_to_arrays(configs: "Sequence[AccelConfig] | ConfigBatch"
                       ) -> Dict[str, np.ndarray]:
    if isinstance(configs, ConfigBatch):
        m = configs.matrix
        return {f: m[:, j:j + 1] for j, f in enumerate(_CFG_FIELDS)}
    return {
        f: np.asarray([getattr(c, f) for c in configs],
                      dtype=np.int64).reshape(len(configs), 1)
        for f in _CFG_FIELDS
    }


# rows of one device pass: about 40 [chunk, O] int64/float64 temporaries
# are live at once, about 3 GB at a 577-op zoo stream (a whole 262,144-row
# pool would need about 48 GB).  Rows are independent, so the chunking
# changes no bit.
_BROADCAST_CHUNK = 16384

_BACKENDS = ("tables", "broadcast", "numpy-ref")

# below this many configs the table pass's setup outweighs what it saves
# (the reference's `_FAST_PATH_MIN_POOL`)
_TABLES_MIN_POOL = 64

#: the passes `evaluate_stream_many` ran, by name ("tables", "broadcast",
#: "numpy-ref"), one count a call; callers clear it to count a run
PASSES: "collections.Counter[str]" = collections.Counter()


def evaluate_stream_many(
    configs: "Sequence[AccelConfig] | ConfigBatch",
    stream: OpStream,
    hw: HardwareConstants = HardwareConstants(),
    peak_weight_bits: int = 0,
    peak_input_bits: int = 0,
    backend: str = "tables",
    with_parts: bool = True,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray, Optional[Dict[str, np.ndarray]]]:
    """Evaluate many configurations against one op stream.

    Backends (bit for bit the same):
      "tables"     (default) the JAX package's default ("numpy") on
                   `device`: pools of at least `_TABLES_MIN_POOL` configs
                   on a non-empty stream whose kernels and strides are all
                   > 0 take the table pass, which costs the stream's
                   unique op columns from `_FusedTables` rows fetched with
                   `gather_rows`; every other input takes the broadcast
                   pass.  The choice is by input, never a fallback on
                   failure;
      "broadcast"  the Eqs. (1)-(13) broadcast formulas on `device`, in
                   int64/float64, `_BROADCAST_CHUNK` config rows at a time;
      "numpy-ref"  the same formulas verbatim in numpy on the host — the
                   oracle the device passes are tested against (`device`
                   is not used).

    The pass that ran is counted in `PASSES` and named in the
    ``evaluate_stream_many`` span's ``route``.  Returns
    ``(total_cycles[C], valid[C], parts)`` as numpy arrays, where parts
    carries the [C, O] compute / weight / input / total cycle matrices and
    the per-op validity for analysis (``with_parts=False`` returns None
    there: cycles and validity only, as scoring consumes)."""
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{_BACKENDS}")
    route = backend
    if backend == "tables":
        route = ("tables" if len(configs) >= _TABLES_MIN_POOL
                 and _tables_support(stream) else "broadcast")
    PASSES[route] += 1
    with obs.span("evaluate_stream_many", backend=backend, route=route,
                  ops=len(stream)):
        if route == "numpy-ref":
            total_cycles, valid, parts = _evaluate_stream_many_ref(
                configs, stream, hw, peak_weight_bits, peak_input_bits)
            return total_cycles, valid, (parts if with_parts else None)
        if route == "tables":
            return _evaluate_stream_many_tables(
                configs, stream, hw, peak_weight_bits, peak_input_bits,
                with_parts, resolve_device(device))
        return _evaluate_stream_many_broadcast(
            configs, stream, hw, peak_weight_bits, peak_input_bits,
            with_parts, resolve_device(device))


def _tables_support(stream: OpStream) -> bool:
    """The table pass takes non-empty streams whose kernels and strides
    are all > 0 (the fused scorer's rule, `FusedTorchScorer.supports`)."""
    return bool(len(stream)
                and (stream.nkx > 0).all() and (stream.nky > 0).all()
                and (stream.s > 0).all())


def _evaluate_stream_many_ref(configs, stream: OpStream,
                              hw: HardwareConstants, peak_weight_bits: int,
                              peak_input_bits: int):
    """The verbatim numpy formulas (the JAX package's `numpy-ref`)."""
    c = _configs_to_arrays(configs)
    o = stream  # row vectors [1, O]

    # ---- effective tiling (T* clamped into [1, N*]; Tkx=Nkx, Tky=Nky) ----
    tif = np.minimum(c["tif"], o.nif)
    tix = np.minimum(c["tix"], o.nix)
    tiy = np.minimum(c["tiy"], o.niy)
    tof = np.minimum(c["tof"], o.nof)
    tkx, tky = o.nkx, o.nky
    # output-tile extents implied by the input tile (stride-aware); numpy
    # gives 0 for an integer division by a zero stride
    with np.errstate(divide="ignore"):
        tox = np.clip((tix - o.nkx) // o.s + 1, 1, o.nox)
        toy = np.clip((tiy - o.nky) // o.s + 1, 1, o.noy)

    # ---- effective unrolling (P* <= T* <= N*) ----
    pif = np.minimum(c["pif"], tif)
    pof = np.minimum(c["pof"], tof)
    pox = np.minimum(c["pox"], tox)
    poy = np.minimum(c["poy"], toy)
    pkx = np.minimum(c["pkx"], tkx)
    pky = np.minimum(c["pky"], tky)
    pb = np.minimum(c["pb"], o.batch)

    unroll = pif * pof * pox * poy * pkx * pky * pb
    total_macs = c["pe_group"] * c["mac_per_group"]
    # Eq. (9): PE_group x MAC/group >= required parallel MACs/cycle
    valid_macs = unroll <= total_macs

    # ---- compute latency: Eq. (3) inter-tiling x inner-tiling ----
    inter = (_ceil_div(o.nif, tif) * _ceil_div(o.nkx, tkx)
             * _ceil_div(o.nky, tky) * _ceil_div(o.nox, tox)
             * _ceil_div(o.noy, toy) * _ceil_div(o.nof, tof))
    inner = (_ceil_div(tif, pif) * _ceil_div(tkx, pkx) * _ceil_div(tky, pky)
             * _ceil_div(tox, pox) * _ceil_div(toy, poy)
             * _ceil_div(tof, pof))
    batch_iters = _ceil_div(o.batch, pb)
    compute_cycles = inter * inner * batch_iters * o.repeat

    # ---- data reuse: Eqs. (1)-(2) (Pix ~ Pox, Piy ~ Poy as in [1]) ----
    weight_reuse = pox * poy * pb                                   # Eq. (1)
    in_win_x = (pox - 1) * o.s + pkx
    in_win_y = (poy - 1) * o.s + pky
    input_reuse = np.maximum(
        (pof * pkx * pky * pox * poy) // np.maximum(in_win_x * in_win_y, 1),
        1)                                                          # Eq. (2)

    # ---- memory fetch volume: Eqs. (5)-(6), + loop-order refetch model ----
    num_weight = (o.nox * o.noy * o.nkx * o.nky * o.nif * o.nof
                  * o.repeat).astype(np.float64)                    # Eq. (5)
    num_input = num_weight * o.batch                                # Eq. (6)

    lo = c["loop_order"]
    spatial_tiles = _ceil_div(o.nox, tox) * _ceil_div(o.noy, toy)
    ofm_tiles = _ceil_div(o.nof, tof)
    # WEIGHT_STATIONARY: each weight word loaded once per (ifm x ofm) tile
    # pass; inputs refetched for every output-channel tile.
    ws_weight = (o.weight_elems_arr() * 1.0)
    ws_input = (o.input_elems_arr() * o.batch * ofm_tiles).astype(np.float64)
    # OUTPUT_STATIONARY: outputs resident; weights refetched per spatial
    # tile, inputs refetched per output-channel tile.
    os_weight = (o.weight_elems_arr() * spatial_tiles).astype(np.float64)
    os_input = ws_input
    # INPUT_STATIONARY: inputs resident once; weights refetched per spatial
    # tile pass.
    is_weight = os_weight
    is_input = (o.input_elems_arr() * o.batch * 1.0)

    num_weight_eff = np.where(
        lo == LoopOrder.PAPER, num_weight / np.maximum(weight_reuse, 1),
        np.where(lo == LoopOrder.WEIGHT_STATIONARY, ws_weight,
                 np.where(lo == LoopOrder.OUTPUT_STATIONARY, os_weight,
                          is_weight)))
    num_input_eff = np.where(
        lo == LoopOrder.PAPER, num_input / np.maximum(input_reuse, 1),
        np.where(lo == LoopOrder.WEIGHT_STATIONARY, ws_input,
                 np.where(lo == LoopOrder.OUTPUT_STATIONARY, os_input,
                          is_input)))

    wbw = np.maximum(c["weight_banks_pg"] * c["pe_group"] * c["bank_width"]
                     // hw.bit_width, 1)
    abw = np.maximum(c["act_banks_pg"] * c["pe_group"] * c["bank_width"]
                     // hw.bit_width, 1)
    weight_cycles = np.ceil(num_weight_eff / wbw)                   # Eq. (7)
    input_cycles = np.ceil(num_input_eff / abw)                     # Eq. (8)

    # ---- total: max(compute, memory) ----
    total = np.maximum(compute_cycles,
                       np.maximum(weight_cycles, input_cycles))

    # ---- buffer-capacity constraints: Eqs. (10)-(13) ----
    wbuf = (c["weight_banks_pg"] * c["pe_group"] * c["bank_height"]
            * c["bank_width"])
    abuf = (c["act_banks_pg"] * c["pe_group"] * c["bank_height"]
            * c["bank_width"])
    need_w_tile = tkx * tky * tif * tof * hw.bit_width              # Eq. (10)
    need_a_tile = (tix * tiy * tif + tox * toy * tof) * hw.bit_width  # Eq.(12)
    valid_buf = (wbuf >= need_w_tile) & (abuf >= need_a_tile)
    if peak_weight_bits:
        valid_buf = valid_buf & (wbuf >= peak_weight_bits)          # Eq. (11)
    if peak_input_bits:
        # Eq. (13): peak input demand scales with batch
        valid_buf = valid_buf & (abuf >= peak_input_bits * o.batch.max())

    valid = (valid_macs & valid_buf).all(axis=1)
    total_cycles = total.sum(axis=1)
    parts = {
        "compute": compute_cycles,
        "weight": weight_cycles,
        "input": input_cycles,
        "total": total,
        "valid_ops": (valid_macs & valid_buf),
    }
    return total_cycles, valid, parts


def _floor_div_t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """numpy's `a // b` on int64 tensors: floor rounding, and 0 where b is
    0 (torch raises on the CPU and gives garbage on a GPU there)."""
    zero = b == 0
    q = torch.div(a, torch.where(zero, 1, b), rounding_mode="floor")
    return torch.where(zero, 0, q)


def _ceil_div_t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return -torch.div(-a, torch.clamp(b, min=1), rounding_mode="floor")


def _broadcast_pass(c: Dict[str, torch.Tensor], o: Dict[str, torch.Tensor],
                    bit_width: int, peak_weight_bits: int,
                    peak_input_scaled: int) -> Tuple[torch.Tensor, ...]:
    """`_evaluate_stream_many_ref` on device tensors: `c` maps each config
    field to a [C, 1] int64 column, `o` each stream field (and the Table-1
    element counts) to a [1, O] int64 row.  Every operation is the
    reference's, in its order and its types: int64 stays int64, and each
    `* 1.0` / `.astype(np.float64)` is an explicit float64 conversion (a
    Python float would make float32).  Returns (total_cycles, valid,
    compute, weight, input, total, valid_ops)."""
    f64 = torch.float64
    mn = torch.minimum
    tif = mn(c["tif"], o["nif"])
    tix = mn(c["tix"], o["nix"])
    tiy = mn(c["tiy"], o["niy"])
    tof = mn(c["tof"], o["nof"])
    tkx, tky = o["nkx"], o["nky"]
    tox = mn(torch.clamp(_floor_div_t(tix - o["nkx"], o["s"]) + 1, min=1),
             o["nox"])
    toy = mn(torch.clamp(_floor_div_t(tiy - o["nky"], o["s"]) + 1, min=1),
             o["noy"])

    pif = mn(c["pif"], tif)
    pof = mn(c["pof"], tof)
    pox = mn(c["pox"], tox)
    poy = mn(c["poy"], toy)
    pkx = mn(c["pkx"], tkx)
    pky = mn(c["pky"], tky)
    pb = mn(c["pb"], o["batch"])

    unroll = pif * pof * pox * poy * pkx * pky * pb
    total_macs = c["pe_group"] * c["mac_per_group"]
    valid_macs = unroll <= total_macs                               # Eq. (9)

    cd = _ceil_div_t
    inter = (cd(o["nif"], tif) * cd(o["nkx"], tkx) * cd(o["nky"], tky)
             * cd(o["nox"], tox) * cd(o["noy"], toy) * cd(o["nof"], tof))
    inner = (cd(tif, pif) * cd(tkx, pkx) * cd(tky, pky) * cd(tox, pox)
             * cd(toy, poy) * cd(tof, pof))
    batch_iters = cd(o["batch"], pb)
    compute_cycles = inter * inner * batch_iters * o["repeat"]      # Eq. (3)

    weight_reuse = pox * poy * pb                                   # Eq. (1)
    in_win_x = (pox - 1) * o["s"] + pkx
    in_win_y = (poy - 1) * o["s"] + pky
    input_reuse = torch.clamp(
        torch.div(pof * pkx * pky * pox * poy,
                  torch.clamp(in_win_x * in_win_y, min=1),
                  rounding_mode="floor"), min=1)                    # Eq. (2)

    num_weight = (o["nox"] * o["noy"] * o["nkx"] * o["nky"] * o["nif"]
                  * o["nof"] * o["repeat"]).to(f64)                 # Eq. (5)
    num_input = num_weight * o["batch"]                             # Eq. (6)

    lo = c["loop_order"]
    spatial_tiles = cd(o["nox"], tox) * cd(o["noy"], toy)
    ofm_tiles = cd(o["nof"], tof)
    ws_weight = o["weight_elems"].to(f64)
    ws_input = (o["input_elems"] * o["batch"] * ofm_tiles).to(f64)
    os_weight = (o["weight_elems"] * spatial_tiles).to(f64)
    os_input = ws_input
    is_weight = os_weight
    is_input = (o["input_elems"] * o["batch"]).to(f64)

    paper = lo == int(LoopOrder.PAPER)
    ws = lo == int(LoopOrder.WEIGHT_STATIONARY)
    os_ = lo == int(LoopOrder.OUTPUT_STATIONARY)
    # float64 / int64 divides in float64 (IEEE, correctly rounded), as
    # numpy does; the divisors are device tensors, never host scalars
    num_weight_eff = torch.where(
        paper, num_weight / torch.clamp(weight_reuse, min=1),
        torch.where(ws, ws_weight, torch.where(os_, os_weight, is_weight)))
    num_input_eff = torch.where(
        paper, num_input / torch.clamp(input_reuse, min=1),
        torch.where(ws, ws_input, torch.where(os_, os_input, is_input)))

    wbw = torch.clamp(torch.div(
        c["weight_banks_pg"] * c["pe_group"] * c["bank_width"], bit_width,
        rounding_mode="floor"), min=1)
    abw = torch.clamp(torch.div(
        c["act_banks_pg"] * c["pe_group"] * c["bank_width"], bit_width,
        rounding_mode="floor"), min=1)
    weight_cycles = torch.ceil(num_weight_eff / wbw)                # Eq. (7)
    input_cycles = torch.ceil(num_input_eff / abw)                  # Eq. (8)

    total = torch.maximum(compute_cycles.to(f64),
                          torch.maximum(weight_cycles, input_cycles))

    wbuf = (c["weight_banks_pg"] * c["pe_group"] * c["bank_height"]
            * c["bank_width"])
    abuf = (c["act_banks_pg"] * c["pe_group"] * c["bank_height"]
            * c["bank_width"])
    need_w_tile = tkx * tky * tif * tof * bit_width                 # Eq. (10)
    need_a_tile = (tix * tiy * tif + tox * toy * tof) * bit_width   # Eq. (12)
    valid_ops = valid_macs & (wbuf >= need_w_tile) & (abuf >= need_a_tile)
    if peak_weight_bits:
        valid_ops &= wbuf >= peak_weight_bits                       # Eq. (11)
    if peak_input_scaled:
        valid_ops &= abuf >= peak_input_scaled                      # Eq. (13)

    valid = valid_ops.all(dim=1)
    # the row sums in numpy's pairwise order (the terms are integers, so
    # below 2^53 any order gives these bits; this one does at any size)
    total_cycles = numpy_order_sum(total.t().contiguous())
    return (total_cycles, valid, compute_cycles, weight_cycles, input_cycles,
            total, valid_ops)


_PARTS = ("compute", "weight", "input", "total", "valid_ops")


def _evaluate_stream_many_broadcast(configs, stream: OpStream,
                                    hw: HardwareConstants,
                                    peak_weight_bits: int,
                                    peak_input_bits: int, with_parts: bool,
                                    device: torch.device):
    matrix = ConfigBatch.from_configs(configs).matrix
    n, n_ops = matrix.shape[0], len(stream)
    peak_input_scaled = (int(peak_input_bits) * int(stream.batch.max())
                         if peak_input_bits else 0)
    rows = {f: getattr(stream, f) for f in OpStream.FIELDS}
    rows["weight_elems"] = stream.weight_elems_arr()
    rows["input_elems"] = stream.input_elems_arr()
    o = {f: torch.from_numpy(np.ascontiguousarray(v, dtype=np.int64)).to(
        device) for f, v in rows.items()}

    total_cycles = np.empty(n, dtype=np.float64)
    valid = np.empty(n, dtype=bool)
    parts = None
    if with_parts:
        dtypes = (np.int64, np.float64, np.float64, np.float64, bool)
        parts = {k: np.empty((n, n_ops), dtype=d)
                 for k, d in zip(_PARTS, dtypes)}
    step = max(1, int(_BROADCAST_CHUNK))
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        m = torch.from_numpy(matrix[lo:hi]).to(device)
        c = {f: m[:, j:j + 1] for j, f in enumerate(_CFG_FIELDS)}
        out = _broadcast_pass(c, o, int(hw.bit_width),
                              int(peak_weight_bits), peak_input_scaled)
        total_cycles[lo:hi] = out[0].cpu().numpy()
        valid[lo:hi] = out[1].cpu().numpy()
        if with_parts:
            for k, t in zip(_PARTS, out[2:]):
                parts[k][lo:hi] = t.cpu().numpy()
    return total_cycles, valid, parts


# config fields the device passes' tails read directly
_TAIL_FIELDS = ("loop_order", "pe_group", "mac_per_group", "bank_height",
                "bank_width", "weight_banks_pg", "act_banks_pg")
# live tensors at the peak of one pass, with some margin: the broadcast
# pass holds about 40 [rows, O] ones, the table pass 35-51 [rows, U] ones
# and one or two [rows, O] float64 expansions of the totals (an H100's
# `max_memory_allocated` on four streams, `chip_smoke.py` study pareto)
_BROADCAST_LIVE = 40
_TABLES_LIVE = 64


def _tables_chunk(n_unique: int, n_ops: int) -> int:
    """Rows of one table pass, so that its live bytes stay within the
    broadcast pass's at `_BROADCAST_CHUNK` rows.  Rows are independent,
    so the chunking changes no bit."""
    budget = max(1, int(_BROADCAST_CHUNK)) * _BROADCAST_LIVE * n_ops
    return max(1, budget // (_TABLES_LIVE * n_unique + 2 * n_ops))


def _table_rows(c: Dict[str, torch.Tensor], nv: Dict[str, int]
                ) -> Dict[str, torch.Tensor]:
    """Each device table's row of every config, from the per-field codes
    `c`, in the order `_FusedTables`'s grids lay the rows out."""
    i_xp = c["tix"] * nv["pox"] + c["pox"]
    i_yp = c["tiy"] * nv["poy"] + c["poy"]
    return {
        "pb_tbl": c["pb"],
        "ifp_tbl": c["tif"] * nv["pif"] + c["pif"],
        "ofp_tbl": c["tof"] * nv["pof"] + c["pof"],
        "xp_tbl": i_xp,
        "yp_tbl": i_yp,
        "kk_tbl": c["pkx"] * nv["pky"] + c["pky"],
        "wt_tbl": c["tif"] * nv["tof"] + c["tof"],
        "spatial_tbl": c["tix"] * nv["tiy"] + c["tiy"],
        "win_x_tbl": i_xp * nv["pkx"] + c["pkx"],
        "win_y_tbl": i_yp * nv["pky"] + c["pky"],
        "atile_tbl": ((c["tix"] * nv["tiy"] + c["tiy"]) * nv["tif"]
                      + c["tif"]) * nv["tof"] + c["tof"],
    }


def _evaluate_stream_many_tables(configs, stream: OpStream,
                                 hw: HardwareConstants,
                                 peak_weight_bits: int,
                                 peak_input_bits: int, with_parts: bool,
                                 device: torch.device):
    """The JAX package's `_evaluate_stream_many_fast` on `device`.

    The [U, O] tables over the stream's unique op columns are the fused
    scorer's `_FusedTables` (the reference's expressions, built in numpy
    on the host, grown from the pools' values); their device copies come
    from `DeviceTables`.  Each config's rows are fetched with
    `gather_rows`, one launch an index (eleven a chunk): a stacked table's
    k tables share one.  The tail is the reference's chunk body in its
    order and types, on the unique columns; the per-config sum runs over
    the original columns (`expand`) in numpy's pairwise order."""
    f64 = torch.float64
    matrix = ConfigBatch.from_configs(configs).matrix
    n, n_ops = matrix.shape[0], len(stream)
    t = _fused_tables_for(stream, hw, None)
    code = t.codes(matrix)              # may grow and rebuild the tables
    per_device = _TABLE_PASS_UPLOADS.setdefault(t, {})
    up = per_device.setdefault(str(device), DeviceTables(t, device))
    dv, nv = up.get(), t.nvals
    J = ConfigBatch._INDEX
    code_rows = np.stack([code[f] for f in _FAST_FIELDS])
    tail = matrix[:, [J[f] for f in _TAIL_FIELDS]]
    expand = dv["expand"]
    bit_width = int(hw.bit_width)
    peak_input_scaled = (int(peak_input_bits) * t.max_batch
                         if peak_input_bits else 0)
    paper = int(LoopOrder.PAPER)
    ws = int(LoopOrder.WEIGHT_STATIONARY)
    os_ = int(LoopOrder.OUTPUT_STATIONARY)

    total_cycles = np.empty(n, dtype=np.float64)
    valid = np.empty(n, dtype=bool)
    parts = None
    if with_parts:
        dtypes = (np.int64, np.float64, np.float64, np.float64, bool)
        parts = {p: np.empty((n, n_ops), dtype=d)
                 for p, d in zip(_PARTS, dtypes)}
    step = _tables_chunk(len(t.ops), n_ops)
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        # one contiguous row of codes a field (`gather_rows` takes
        # contiguous indices), uploaded a chunk at a time
        codes = torch.from_numpy(np.ascontiguousarray(
            code_rows[:, lo:hi])).to(device)
        cols = torch.from_numpy(np.ascontiguousarray(tail[lo:hi])).to(
            device)
        kc = {f: cols[:, j:j + 1] for j, f in enumerate(_TAIL_FIELDS)}
        rows = _table_rows({f: codes[j] for j, f in enumerate(_FAST_FIELDS)},
                           nv)
        g = {name: gather_rows(dv[name], idx) for name, idx in rows.items()}
        batch_iters, pb = split_rows(g["pb_tbl"], 2)
        cd_if, pif = split_rows(g["ifp_tbl"], 2)
        cd_of, pof = split_rows(g["ofp_tbl"], 2)
        cd_ox, pox = split_rows(g["xp_tbl"], 2)
        cd_oy, poy = split_rows(g["yp_tbl"], 2)
        cd_kk, p_kxky = split_rows(g["kk_tbl"], 2)
        chan_tiles, need_w_tile, ofm_tiles = split_rows(g["wt_tbl"], 3)
        spatial_tiles = g["spatial_tbl"]
        in_win_x, in_win_y = g["win_x_tbl"], g["win_y_tbl"]
        need_a_tile = g["atile_tbl"]                  # Eqs. (10), (12): bits

        poxy = pox * poy
        unroll = pif * pof * poxy * p_kxky * pb
        total_macs = kc["pe_group"] * kc["mac_per_group"]
        valid_macs = unroll <= total_macs                        # Eq. (9)

        # the ceil(Nk/Tk) factors are exactly 1 (Tkx=Nkx, Tky=Nky) and
        # are dropped from the Eq. (3) products, as the reference does
        inter = chan_tiles * spatial_tiles
        inner = cd_if * cd_kk * cd_ox * cd_oy * cd_of
        compute_cycles = inter * inner * batch_iters * dv["repeat"]

        weight_reuse = poxy * pb                                 # Eq. (1)
        input_reuse = torch.clamp(torch.div(
            pof * p_kxky * poxy, torch.clamp(in_win_x * in_win_y, min=1),
            rounding_mode="floor"), min=1)                       # Eq. (2)

        lo_ord = kc["loop_order"]
        ws_input = (dv["ie_batch"] * ofm_tiles).to(f64)
        os_weight = (dv["weight_elems"] * spatial_tiles).to(f64)
        os_input = ws_input
        is_weight = os_weight
        # float64 / int64 divides in float64, as numpy does; the divisors
        # are device tensors, never host scalars
        num_weight_eff = torch.where(
            lo_ord == paper,
            dv["num_weight"] / torch.clamp(weight_reuse, min=1),
            torch.where(lo_ord == ws, dv["ws_weight"],
                        torch.where(lo_ord == os_, os_weight, is_weight)))
        num_input_eff = torch.where(
            lo_ord == paper,
            dv["num_input"] / torch.clamp(input_reuse, min=1),
            torch.where(lo_ord == ws, ws_input,
                        torch.where(lo_ord == os_, os_input,
                                    dv["is_input"])))

        wbw = torch.clamp(torch.div(
            kc["weight_banks_pg"] * kc["pe_group"] * kc["bank_width"],
            bit_width, rounding_mode="floor"), min=1)
        abw = torch.clamp(torch.div(
            kc["act_banks_pg"] * kc["pe_group"] * kc["bank_width"],
            bit_width, rounding_mode="floor"), min=1)
        weight_cycles = torch.ceil(num_weight_eff / wbw)         # Eq. (7)
        input_cycles = torch.ceil(num_input_eff / abw)           # Eq. (8)
        total = torch.maximum(compute_cycles.to(f64),
                              torch.maximum(weight_cycles, input_cycles))

        wbuf = (kc["weight_banks_pg"] * kc["pe_group"] * kc["bank_height"]
                * kc["bank_width"])
        abuf = (kc["act_banks_pg"] * kc["pe_group"] * kc["bank_height"]
                * kc["bank_width"])
        valid_ops = (valid_macs & (wbuf >= need_w_tile)
                     & (abuf >= need_a_tile))
        if peak_weight_bits:
            valid_ops &= wbuf >= int(peak_weight_bits)          # Eq. (11)
        if peak_input_scaled:
            valid_ops &= abuf >= peak_input_scaled              # Eq. (13)

        # all() over repeated columns equals all() over the unique ones;
        # the sum runs over the original columns, in numpy's order
        valid[lo:hi] = valid_ops.all(dim=1).cpu().numpy()
        total_cycles[lo:hi] = numpy_order_sum(
            total.t()[expand].contiguous()).cpu().numpy()
        if with_parts:
            for p, v in zip(_PARTS, (compute_cycles, weight_cycles,
                                     input_cycles, total, valid_ops)):
                parts[p][lo:hi] = v[:, expand].cpu().numpy()
    return total_cycles, valid, parts


def evaluate_stream(config: AccelConfig, stream: OpStream,
                    hw: HardwareConstants = HardwareConstants(),
                    peak_weight_bits: int = 0,
                    peak_input_bits: int = 0,
                    device="cuda") -> LatencyBreakdown:
    """Evaluate a single configuration on `device` (one config: the
    broadcast pass, by `evaluate_stream_many`'s dispatch); returns the
    per-op breakdown."""
    _, _, parts = evaluate_stream_many(
        [config], stream, hw, peak_weight_bits, peak_input_bits,
        device=device)
    return LatencyBreakdown(
        compute_cycles=parts["compute"][0],
        weight_cycles=parts["weight"][0],
        input_cycles=parts["input"][0],
        total_cycles=parts["total"][0],
        valid=parts["valid_ops"][0],
    )


def performance_gops(configs: "Sequence[AccelConfig] | ConfigBatch",
                     stream: OpStream,
                     hw: HardwareConstants = HardwareConstants(),
                     peak_weight_bits: int = 0,
                     peak_input_bits: int = 0,
                     backend: str = "tables",
                     device="cuda") -> np.ndarray:
    """GOPS per configuration; 0.0 where the config violates constraints
    (the paper plots constraint-violating configurations at 0 GOPS, Fig.
    7).  The cycles and validity come from `evaluate_stream_many` on
    `device`; the tail runs on the host in numpy, as the JAX package's
    does, so a division by a host scalar never runs on the device."""
    cycles, valid, _ = evaluate_stream_many(
        configs, stream, hw, peak_weight_bits, peak_input_bits,
        backend=backend, with_parts=False, device=device)
    seconds = cycles / hw.frequency_hz
    gops = np.where(valid & (cycles > 0),
                    stream.total_ops / np.maximum(seconds, 1e-30) / 1e9,
                    0.0)
    return gops


# --------------------------------------------------------------------------
# Optional finer-grained buffer simulator (paper §3, last paragraph).
# --------------------------------------------------------------------------

class BufferSimulator:
    """Block-level buffer residency simulator.

    The layer is split into `n_blocks` computational blocks (loop-tile
    granularity).  Each block costs its compute latency; if its input/weight
    tile is not resident in the on-chip buffer, an off-chip transfer latency
    is charged and the tile is installed with LRU eviction.  This refines the
    idealized max(compute, memory) model when the working set exceeds the
    buffer ("The number of computational blocks is a trade-off between
    estimation speed and accuracy").
    """

    def __init__(self, config: AccelConfig,
                 hw: HardwareConstants = HardwareConstants(),
                 n_blocks: int = 64):
        self.cfg = config
        self.hw = hw
        self.n_blocks = n_blocks

    def simulate_op(self, op: Op) -> int:
        cfg, hw = self.cfg, self.hw
        tif = min(cfg.tif, op.nif)
        tix = min(cfg.tix, op.nix)
        tiy = min(cfg.tiy, op.niy)
        tof = min(cfg.tof, op.nof)
        tox = max(min((tix - op.nkx) // op.s + 1, op.nox), 1)
        toy = max(min((tiy - op.nky) // op.s + 1, op.noy), 1)

        n_if = -(-op.nif // tif)
        n_of = -(-op.nof // tof)
        n_sp = -(-op.nox // tox) * -(-op.noy // toy)
        blocks = []
        for b in range(min(self.n_blocks, n_if * n_of * n_sp)):
            i = b % n_if
            f = (b // n_if) % n_of
            sp = b // (n_if * n_of)
            blocks.append((i, f, sp))
        scale = max(1, (n_if * n_of * n_sp) / max(len(blocks), 1))

        w_tile_bits = op.nkx * op.nky * tif * tof * hw.bit_width
        a_tile_bits = tix * tiy * tif * hw.bit_width
        wbuf = cfg.weight_buffer_bits()
        abuf = cfg.act_buffer_bits()
        w_slots = max(1, wbuf // max(w_tile_bits, 1))
        a_slots = max(1, abuf // max(a_tile_bits, 1))

        # per-block compute latency (inner-tiling latency of Eq. (4))
        pif = min(cfg.pif, tif)
        pof = min(cfg.pof, tof)
        pox = min(cfg.pox, tox)
        poy = min(cfg.poy, toy)
        pkx = min(cfg.pkx, op.nkx)
        pky = min(cfg.pky, op.nky)
        inner = (-(-tif // pif) * -(-op.nkx // pkx) * -(-op.nky // pky)
                 * -(-tox // pox) * -(-toy // poy) * -(-tof // pof))

        w_lru: List[Tuple[int, int]] = []   # (ifm_tile, ofm_tile)
        a_lru: List[Tuple[int, int]] = []   # (ifm_tile, spatial_tile)
        cycles = 0
        xfer = hw.offchip_words_per_cycle
        for (i, f, sp) in blocks:
            cycles += inner
            wkey, akey = (i, f), (i, sp)
            if wkey not in w_lru:
                cycles += hw.offchip_burst_setup + \
                    w_tile_bits // hw.bit_width // xfer
                w_lru.append(wkey)
                if len(w_lru) > w_slots:
                    w_lru.pop(0)
            else:
                w_lru.remove(wkey)
                w_lru.append(wkey)
            if akey not in a_lru:
                cycles += hw.offchip_burst_setup + \
                    a_tile_bits // hw.bit_width // xfer
                a_lru.append(akey)
                if len(a_lru) > a_slots:
                    a_lru.pop(0)
            else:
                a_lru.remove(akey)
                a_lru.append(akey)
        return int(cycles * scale * op.repeat * op.batch)

    def simulate(self, stream: OpStream) -> int:
        return sum(self.simulate_op(op) for op in stream.ops)
