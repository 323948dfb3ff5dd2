"""Accelerator design space (paper Table 2 + §2.2 unrolling variables).

A `DesignSpace` is an ordered mapping from design-variable name to its
discrete domain.  `sample()` draws a random valid starting configuration
(Algorithm 1 line 1); `neighbors_over()` enumerates one variable's domain
with all others fixed (Algorithm 1 lines 5-9).

The default space mirrors the paper's Table 2 plus the P* unrolling factors
of §2.2, with power-of-two domains as is standard for banked-SRAM/systolic
design points.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.costmodel import (AccelConfig, ConfigBatch,
                                  HardwareConstants, LoopOrder, area_many)

__all__ = ["DesignSpace", "default_space", "DEFAULT_AREA_BUDGET"]


def _pow2(lo: int, hi: int) -> Tuple[int, ...]:
    out = []
    v = lo
    while v <= hi:
        out.append(v)
        v *= 2
    return tuple(out)


@dataclasses.dataclass
class DesignSpace:
    """Discrete domains for every design variable of `AccelConfig`."""

    domains: Dict[str, Tuple[int, ...]]
    hw: HardwareConstants = dataclasses.field(default_factory=HardwareConstants)
    area_budget: float = 0.0

    @property
    def variables(self) -> List[str]:
        return list(self.domains.keys())

    def size(self) -> float:
        n = 1.0
        for d in self.domains.values():
            n *= len(d)
        return n

    def sample(self, rng: np.random.Generator,
               max_tries: int = 1000,
               validator=None) -> AccelConfig:
        """Random *valid* configuration (Algorithm 1 line 1).

        `validator(cfg) -> bool` may additionally enforce the Eq. 9-13
        application constraints so the greedy search never starts from a
        0-GOPS point.
        """
        for _ in range(max_tries):
            kwargs = {k: int(rng.choice(v)) for k, v in self.domains.items()}
            cfg = AccelConfig(**kwargs)
            if self.area_budget > 0 and cfg.area(self.hw) > self.area_budget:
                continue
            if validator is not None and not validator(cfg):
                continue
            return cfg
        raise RuntimeError("could not sample a valid configuration; loosen "
                           "the area budget or shrink the space")

    def neighbors_over(self, cfg: AccelConfig,
                       variable: str) -> List[AccelConfig]:
        """All configurations obtained by sweeping `variable` (others fixed)."""
        out = []
        for v in self.domains[variable]:
            out.append(dataclasses.replace(cfg, **{variable: int(v)}))
        return out

    # ------------------------------------------------ vectorized conversion
    def codec(self):
        """`SpaceCodec` for this space: vectorized config <-> index-array
        conversion so search engines manipulate populations as
        struct-of-arrays instead of lists of dataclasses."""
        from repro_torch.core.search.base import SpaceCodec
        codec = getattr(self, "_codec", None)
        if codec is None or codec.domains != {k: tuple(v) for k, v
                                              in self.domains.items()}:
            codec = SpaceCodec(self.domains, AccelConfig)
            self._codec = codec
        return codec

    def encode(self, configs: Sequence[AccelConfig]) -> np.ndarray:
        """configs -> [N, V] int64 domain-index array (columns follow
        `self.variables` order)."""
        return self.codec().encode(configs)

    def decode(self, idx: np.ndarray) -> List[AccelConfig]:
        """[N, V] domain-index array -> AccelConfig list (encode inverse)."""
        return self.codec().decode(idx)

    def decode_batch(self, idx: np.ndarray) -> ConfigBatch:
        """[N, V] domain-index array -> array-native `ConfigBatch`, without
        materializing any dataclass (the engines' scoring fast path)."""
        return ConfigBatch.from_columns(**self.codec().decode_values(idx))

    def encode_batch(self, batch: ConfigBatch) -> np.ndarray:
        """`ConfigBatch` -> [N, V] domain-index array (decode_batch
        inverse; every field value must be a domain member)."""
        codec = self.codec()
        return codec.encode_values(
            {v: batch.col(v) for v in codec.variables})

    def sample_indices(self, rng: np.random.Generator,
                       n: int) -> np.ndarray:
        """Uniform random [n, V] index population (no validity filtering)."""
        return self.codec().sample_indices(rng, n)

    def within_area(self, cfg: AccelConfig) -> bool:
        return self.area_budget <= 0 or cfg.area(self.hw) <= self.area_budget

    def repair_for_peaks(self, cfg: AccelConfig, peak_weight_bits: int,
                         peak_input_bits: int) -> AccelConfig:
        """Minimal domain-respecting repair: grow buffer variables until the
        Eq. (11)/(13) peak-demand floors hold, then shrink compute variables
        until the area budget holds.  Keeps the rest of the random sample
        untouched (Algorithm 1 line 1 needs *a* valid point, not a good
        one)."""
        grow_w = ("bank_height", "weight_banks_pg", "bank_width", "pe_group")
        grow_a = ("bank_height", "act_banks_pg", "bank_width", "pe_group")

        def bump(c: AccelConfig, var: str) -> Optional[AccelConfig]:
            dom = sorted(self.domains[var])
            cur = getattr(c, var)
            bigger = [v for v in dom if v > cur]
            if not bigger:
                return None
            return dataclasses.replace(c, **{var: int(bigger[0])})

        for _ in range(64):
            if cfg.weight_buffer_bits() >= peak_weight_bits:
                break
            for var in grow_w:
                nxt = bump(cfg, var)
                if nxt is not None:
                    cfg = nxt
                    break
            else:
                break
        for _ in range(64):
            if cfg.act_buffer_bits() >= peak_input_bits:
                break
            for var in grow_a:
                nxt = bump(cfg, var)
                if nxt is not None:
                    cfg = nxt
                    break
            else:
                break
        # area repair: shrink compute/tiling first — never the bank
        # variables (that would re-break the buffer floors just grown)
        for var in ("mac_per_group", "tif", "tof"):
            while (self.area_budget > 0
                   and cfg.area(self.hw) > self.area_budget):
                dom = sorted(self.domains[var])
                cur = getattr(cfg, var)
                smaller = [v for v in dom if v < cur]
                if not smaller:
                    break
                cfg = dataclasses.replace(cfg, **{var: int(smaller[-1])})
        # still over budget: the SRAM dominates (oversized banks from a
        # random sample or a crossover/mutation product).  Shrink buffer
        # variables stepwise, but only accept a step that keeps both
        # Eq. 11/13 floors satisfied — repaired genetic offspring must
        # respect the floors AND the area budget simultaneously.
        shrink_bufs = ("bank_height", "act_banks_pg", "weight_banks_pg",
                       "bank_width", "pe_group")
        for _ in range(64):
            if (self.area_budget <= 0
                    or cfg.area(self.hw) <= self.area_budget):
                break
            for var in shrink_bufs:
                dom = sorted(self.domains[var])
                cur = getattr(cfg, var)
                smaller = [v for v in dom if v < cur]
                if not smaller:
                    continue
                cand = dataclasses.replace(cfg, **{var: int(smaller[-1])})
                if (cand.weight_buffer_bits() >= peak_weight_bits
                        and cand.act_buffer_bits() >= peak_input_bits):
                    cfg = cand
                    break
            else:
                break
        return cfg

    # ------------------------------------------------- batched validity repair
    _GROW_W = ("bank_height", "weight_banks_pg", "bank_width", "pe_group")
    _GROW_A = ("bank_height", "act_banks_pg", "bank_width", "pe_group")
    _SHRINK_AREA = ("mac_per_group", "tif", "tof")
    _SHRINK_BUFS = ("bank_height", "act_banks_pg", "weight_banks_pg",
                    "bank_width", "pe_group")

    def _sorted_domain(self, var: str) -> np.ndarray:
        cache = getattr(self, "_sorted_domains", None)
        if cache is None:
            cache = self._sorted_domains = {}
        dom = cache.get(var)
        if dom is None or len(dom) != len(self.domains[var]):
            dom = cache[var] = np.asarray(sorted(self.domains[var]),
                                          dtype=np.int64)
        return dom

    def repair_for_peaks_many(self, configs, peak_weight_bits: int,
                              peak_input_bits: int) -> ConfigBatch:
        """Vectorized `repair_for_peaks` over a whole population.

        Row `i` of the result equals
        ``repair_for_peaks(configs[i], peak_weight_bits, peak_input_bits)``
        exactly: each phase iterates the same bounded repair schedule, but
        one numpy mask operation per step repairs every still-unsatisfied
        row at once instead of a Python loop per offspring.  Accepts a
        `ConfigBatch` or any `AccelConfig` sequence; returns a new
        `ConfigBatch` (inputs are never mutated)."""
        batch = ConfigBatch.from_configs(configs)
        m = batch.matrix.copy()
        n = m.shape[0]
        j_of = ConfigBatch._INDEX

        def wbuf(mm: np.ndarray) -> np.ndarray:
            return (mm[:, j_of["weight_banks_pg"]] * mm[:, j_of["pe_group"]]
                    * mm[:, j_of["bank_height"]] * mm[:, j_of["bank_width"]])

        def abuf(mm: np.ndarray) -> np.ndarray:
            return (mm[:, j_of["act_banks_pg"]] * mm[:, j_of["pe_group"]]
                    * mm[:, j_of["bank_height"]] * mm[:, j_of["bank_width"]])

        def area(mm: np.ndarray) -> np.ndarray:
            return area_many(ConfigBatch(mm), self.hw)

        # phases A/B: grow the first growable buffer variable (in order)
        # for every row still under its peak floor
        for grow_vars, buf, floor in ((self._GROW_W, wbuf, peak_weight_bits),
                                      (self._GROW_A, abuf, peak_input_bits)):
            for _ in range(64):
                need = buf(m) < floor
                if not need.any():
                    break
                bumped = np.zeros(n, dtype=bool)
                for var in grow_vars:
                    j, dom = j_of[var], self._sorted_domain(var)
                    pos = np.searchsorted(dom, m[:, j], side="right")
                    sel = need & ~bumped & (pos < len(dom))
                    if sel.any():
                        m[sel, j] = dom[pos[sel]]
                        bumped |= sel
                if not bumped.any():      # nothing growable -> scalar `break`
                    break

        # phase C: shrink compute/tiling variables while over the area budget
        if self.area_budget > 0:
            for var in self._SHRINK_AREA:
                j, dom = j_of[var], self._sorted_domain(var)
                for _ in range(len(dom)):
                    pos = np.searchsorted(dom, m[:, j], side="left")
                    sel = (area(m) > self.area_budget) & (pos > 0)
                    if not sel.any():
                        break
                    m[sel, j] = dom[pos[sel] - 1]

            # phase D: shrink buffer variables stepwise, accepting only steps
            # that keep both Eq. 11/13 floors satisfied
            for _ in range(64):
                over = area(m) > self.area_budget
                if not over.any():
                    break
                changed = np.zeros(n, dtype=bool)
                for var in self._SHRINK_BUFS:
                    j, dom = j_of[var], self._sorted_domain(var)
                    pos = np.searchsorted(dom, m[:, j], side="left")
                    sel = over & ~changed & (pos > 0)
                    if not sel.any():
                        continue
                    cand = m[sel].copy()
                    cand[:, j] = dom[pos[sel] - 1]
                    ok = ((wbuf(cand) >= peak_weight_bits)
                          & (abuf(cand) >= peak_input_bits))
                    rows = np.flatnonzero(sel)[ok]
                    m[rows, j] = dom[pos[rows] - 1]
                    changed[rows] = True
                if not changed.any():     # every over row stuck -> break
                    break
        return ConfigBatch(m)


# A representative area budget: room for ~16K MACs plus ~tens of Mbit of
# banked SRAM plus control — large enough that the big-peak applications
# (fasterRCNN, deeplab) are feasible at all, small enough that their memory
# lower bounds (Eqs. 10-13) kill many configurations (the paper's dense
# 0-GOPS lines in Fig. 7(b)/(d)) and compute/memory trade-offs are real.
DEFAULT_AREA_BUDGET = 90000.0


def default_space(hw: Optional[HardwareConstants] = None,
                  area_budget: float = DEFAULT_AREA_BUDGET) -> DesignSpace:
    """The paper-shaped design space (Table 2 variables + P* unrolling)."""
    hw = hw or HardwareConstants()
    domains: Dict[str, Tuple[int, ...]] = {
        "loop_order": tuple(int(v) for v in LoopOrder),
        "pe_group": _pow2(1, 64),
        "mac_per_group": _pow2(16, 512),
        "bank_height": _pow2(256, 8192),
        "bank_width": (16, 32, 64, 128),
        "weight_banks_pg": _pow2(1, 16),
        "act_banks_pg": _pow2(1, 16),
        "tif": _pow2(4, 512),
        "tix": _pow2(8, 256),
        "tiy": _pow2(8, 256),
        "tof": _pow2(4, 512),
        "pif": _pow2(1, 64),
        "pof": _pow2(1, 64),
        "pox": _pow2(1, 16),
        "poy": _pow2(1, 16),
        "pkx": (1, 3, 5, 7),
        "pky": (1, 3, 5, 7),
        "pb": _pow2(1, 16),
    }
    return DesignSpace(domains=domains, hw=hw, area_budget=area_budget)
