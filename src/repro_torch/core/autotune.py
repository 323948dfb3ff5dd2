"""Software-defined DSE for the execution space of one GPU (beyond-paper
layer).

The paper's framework = {application graph} x {analytical cost model} x
{multi-step greedy optimizer}.  Here the *same* optimizer drives the
execution design space of a model step:

  paper variable        ->  execution variable
  ----------------------------------------------------------------
  PE organisation       ->  sharding_mode (fsdp | tp)
  loop tiling T*        ->  microbatches, attn_kv_block, moe_group
  banked buffers        ->  remat policy (activation residency)
  loop_order            ->  kv cache layout axis (model | data)

and the cost model is the dry-run roofline (`launch.dryrun`,
`core.roofline`): score = 1 / max(compute_s, memory_s, collective_s),
with the paper's "0 GOPS on constraint violation" rule mapped to a peak
above the card's memory.

The points, domains and the greedy loop are the reference's
(`repro.core.autotune`), so `ExecPoint.key()` names the same point in both
packages.  On one GPU, serving only: sharding mode, remat, microbatches
and the layout rules (`extra_rules`) change nothing in the step, and
`moe_group_size` only MoE blocks, which the port does not have yet; the
plain attention's KV tile (`attn_kv_block`) is the variable that moves the
step (its peak memory, not its FLOPs).  Engines other than greedy run
through a `FunctionEvaluator` and the evaluator-mode `Study` on the host:
each point they score is one dry-run on fake tensors.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.core.roofline import HW
from repro_torch.core.search import (DiscreteSpace, EngineSpec,
                                     FunctionEvaluator, filter_kwargs)

__all__ = ["ExecPoint", "EXEC_DOMAINS", "CellEvaluator", "exec_space",
           "greedy_autotune", "autotune_search", "select_geomean_config"]


@dataclasses.dataclass(frozen=True)
class ExecPoint:
    """One point in the execution design space."""

    sharding_mode: str = "fsdp"        # fsdp | tp
    remat: str = "full"                # full | dots | none
    microbatches: int = 1              # gradient accumulation factor
    attn_kv_block: int = 1024          # online-softmax KV tile
    moe_group_size: int = 4096         # GShard routing group
    extra_rules: Tuple[Tuple[str, Optional[str]], ...] = ()

    def key(self) -> str:
        return hashlib.sha1(json.dumps(
            dataclasses.asdict(self), sort_keys=True).encode()).hexdigest()[:12]

    def overrides(self) -> Dict[str, Any]:
        return {"attn_kv_block": self.attn_kv_block,
                "moe_group_size": self.moe_group_size}


CACHE_DIR = Path(__file__).resolve().parents[3] / "experiments" \
    / "autotune_torch"

EXEC_DOMAINS: Dict[str, Tuple] = {
    "sharding_mode": ("fsdp", "tp"),
    "remat": ("full", "dots", "none"),
    "microbatches": (1, 2, 4, 8, 16),
    "attn_kv_block": (512, 1024, 2048, 4096),
    "moe_group_size": (2048, 4096, 8192),
    # cache/state layout flips (the paper's loop_order analogue)
    "extra_rules": ((), (("mlstm_state", "model"),),
                    (("kv_seq", None),)),
}


class CellEvaluator:
    """Dry-run and score one (arch x shape) cell on one GPU at an
    ExecPoint, with on-disk memoization by `ExecPoint.key()`.

    `hbm_limit` defaults to the H100's 80 GB (`HW().hbm_bytes`); the dry-run
    counts on fake tensors of `device`.  Points with the same `overrides()`
    run one step on one GPU and share one dry-run; `n_compiles` counts the
    dry-runs."""

    def __init__(self, arch_name: str, shape_name: str,
                 cache_dir: str | Path = CACHE_DIR,
                 hbm_limit: Optional[float] = None, device: str = "cuda"):
        from repro_torch.launch.dryrun import MESH

        self.arch_name = arch_name
        self.shape_name = shape_name
        self.cell = f"{arch_name}_{shape_name}_{MESH}"
        self.dir = Path(cache_dir) / self.cell
        self.dir.mkdir(parents=True, exist_ok=True)
        self.hbm_limit = HW().hbm_bytes if hbm_limit is None else hbm_limit
        self.device = device
        self.n_compiles = 0

    def evaluate(self, pt: ExecPoint) -> Dict[str, Any]:
        cache = self.dir / f"{pt.key()}.json"
        if cache.exists():
            return json.loads(cache.read_text())
        from repro_torch.launch.dryrun import run_cell

        # on one GPU only the overrides change the step: points that differ
        # elsewhere share the dry-run of the first of them, which run_cell
        # writes to `<cell><tag>.json`
        tag = "_step" + hashlib.sha1(json.dumps(
            pt.overrides(), sort_keys=True).encode()).hexdigest()[:12]
        step = self.dir / f"{self.cell}{tag}.json"
        if step.exists():
            rec = json.loads(step.read_text())
        else:
            rec = run_cell(self.arch_name, self.shape_name, self.dir,
                           device=self.device,
                           sharding_mode=pt.sharding_mode, remat=pt.remat,
                           microbatches=pt.microbatches,
                           overrides=pt.overrides(),
                           rule_updates=dict(pt.extra_rules) or None,
                           tag=tag)
            self.n_compiles += 1
        rec["point"] = dataclasses.asdict(pt)
        cache.write_text(json.dumps(rec, indent=2))
        return rec

    def score(self, pt: ExecPoint) -> float:
        """1/roofline_s; 0 on failure or HBM violation (paper's 0-GOPS)."""
        rec = self.evaluate(pt)
        if rec.get("status") != "OK":
            return 0.0
        roof = rec["roofline"]
        if roof["peak_memory_per_chip"] > self.hbm_limit:
            return 0.0
        return 1.0 / max(roof["roofline_s"], 1e-12)


def _domains_for(shape_mode: str, has_moe: bool) -> Dict[str, Tuple]:
    d = dict(EXEC_DOMAINS)
    if shape_mode != "train":
        d["microbatches"] = (1,)
        d["remat"] = ("none",)
        d["sharding_mode"] = ("tp",)
    if not has_moe:
        d["moe_group_size"] = (4096,)
    return d


def exec_space(shape_mode: str = "train", has_moe: bool = False
               ) -> DiscreteSpace:
    """The execution design space as a generic `DiscreteSpace`."""
    return DiscreteSpace(domains=_domains_for(shape_mode, has_moe),
                         make_config=lambda **kw: ExecPoint(**kw))


def autotune_search(evaluator: CellEvaluator, *, engine: EngineSpec = "greedy",
                    shape_mode: str = "train", has_moe: bool = False,
                    seed: int = 0, max_rounds: int = 6,
                    init: Optional[ExecPoint] = None,
                    log: Optional[list] = None,
                    **engine_kwargs) -> Tuple[ExecPoint, float]:
    """Engine-pluggable autotuning of one cell.

    "greedy" keeps the k=1 memoized loop below; other engines run through
    the evaluator-mode `Study` with deliberately small population defaults
    — every scored point is one dry-run, memoized by `CellEvaluator` on
    disk and by `FunctionEvaluator` in memory.
    """
    if engine == "greedy":
        # forward only what greedy_autotune understands, as make_engine
        # does for the other engines
        return greedy_autotune(evaluator, shape_mode=shape_mode,
                               has_moe=has_moe, seed=seed,
                               max_rounds=max_rounds, init=init, log=log,
                               **filter_kwargs(greedy_autotune,
                                               engine_kwargs))
    from repro_torch.dse import SearchBudget, Study

    space = exec_space(shape_mode, has_moe)
    # each pool's cache misses go to score_batch in one call where the
    # evaluator has one; score-only evaluators take the scalar path
    fev = FunctionEvaluator(evaluator.score,
                            batch_score_fn=getattr(evaluator, "score_batch",
                                                   None))
    kw: Dict[str, Any] = {"chains": 2, "population": 6, "batch": 4,
                          "elite": 1}
    kw.update(engine_kwargs)
    if init is not None:
        kw.setdefault("init", init)
    # one engine run over the execution space through the evaluator-mode
    # Study: make_engine's kwarg filtering, the same seed, the same
    # ask/tell loop
    study = Study(space=space, evaluator=fev, engine=engine,
                  budget=SearchBudget(restarts=1, max_rounds=max_rounds,
                                      engine_kwargs=kw),
                  seed=seed, name="autotune")
    res = study.run().per_app_results["space"]
    best, best_perf = res.best, res.best_perf
    if init is not None:
        # engines without an `init` parameter (genetic, random) drop it in
        # make_engine's kwarg filtering — score it explicitly so the
        # starting point is always a candidate (memoized: free if an
        # init-seeded engine already scored it)
        init_score = fev.score_one(init)
        if best is None or init_score > best_perf:
            best, best_perf = init, init_score
    if best is None:
        raise ValueError(
            f"{engine} search evaluated no candidates (max_rounds="
            f"{max_rounds}); use max_rounds >= 1 or pass init=")
    if log is not None:
        log.append({"event": "search", "engine": res.engine,
                    "rounds": res.rounds,
                    "evaluated": [dataclasses.asdict(c)
                                  for c in res.evaluated],
                    "scores": res.evaluated_perf.tolist(),
                    "best": dataclasses.asdict(best)})
    return best, best_perf


def greedy_autotune(evaluator: CellEvaluator, *, shape_mode: str = "train",
                    has_moe: bool = False, seed: int = 0,
                    max_rounds: int = 6, init: Optional[ExecPoint] = None,
                    delta_threshold: float = 0.02,
                    log: Optional[list] = None) -> Tuple[ExecPoint, float]:
    """Algorithm 1 with k=1 over the execution space (memoized evals)."""
    rng = np.random.default_rng(seed)
    domains = _domains_for(shape_mode, has_moe)
    s0 = init or ExecPoint()
    p0 = evaluator.score(s0)
    if log is not None:
        log.append({"event": "init", "point": dataclasses.asdict(s0),
                    "score": p0})
    variables = list(domains.keys())
    stale = 0
    for rnd in range(max_rounds):
        var = variables[int(rng.integers(len(variables)))]
        pool = [s0]
        for v in domains[var]:
            pool.append(dataclasses.replace(s0, **{var: v}))
        scores = [evaluator.score(s) for s in pool]
        i_max = int(np.argmax(scores))
        delta = scores[i_max] - p0
        if log is not None:
            log.append({"event": "round", "var": var,
                        "candidates": [dataclasses.asdict(s) for s in pool],
                        "scores": scores,
                        "picked": dataclasses.asdict(pool[i_max])})
        s0, p0 = pool[i_max], scores[i_max]
        if delta <= delta_threshold * max(p0, 1e-12):
            stale += 1
            if stale >= 2:
                break
        else:
            stale = 0
    return s0, p0


def select_geomean_config(records: Dict[str, Dict[str, float]]
                          ) -> Tuple[str, float]:
    """§5.1 selection on the execution space: records[point_key][arch] =
    score; returns the point key with the best geometric-mean score over
    archs (points missing an arch or scoring 0 anywhere are excluded)."""
    best_key, best_geo = "", 0.0
    n_archs = max(len(v) for v in records.values())
    for key, per_arch in records.items():
        vals = list(per_arch.values())
        if len(vals) < n_archs or any(v <= 0 for v in vals):
            continue
        geo = float(np.exp(np.mean(np.log(vals))))
        if geo > best_geo:
            best_key, best_geo = key, geo
    return best_key, best_geo
