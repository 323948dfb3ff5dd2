"""Software-defined DSE for the execution space of a model step on one
GPU or a mesh of them (beyond-paper layer).

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
packages.  A cell is counted on one GPU (`multi_pod=None`, mesh "1gpu")
or per rank on the reference's 16x16 / 2x16x16 meshes (`multi_pod`
False / True, `launch.dryrun.run_cell`).  Over a mesh every variable
moves the step: sharding mode and the layout rules (`extra_rules`) place
the params, caches and activations, so each rank's memory, FLOPs and
collectives.  On one GPU those two change nothing, nor do remat and
microbatches in a serving cell; in a train cell (`train_4k`) remat moves
what the backward keeps and recomputes (the step's peak and its FLOPs)
and microbatches the activations a pass holds, as the reference's loop
tiling T* and banked buffers do.  The plain attention's KV tile
(`attn_kv_block`) moves the step's peak memory, not its FLOPs, and on an
MoE arch `moe_group_size` moves its MoE blocks: the tokens routed
together, so the dispatch buffers, the capacity a group gives each expert
and with it the expert products' rows.  Engines other than greedy run
through a `FunctionEvaluator` and the evaluator-mode `Study` on the host:
each point they score is one dry-run on fake tensors, and a pool's points
go to `CellEvaluator.score_batch`, which runs them in spawned processes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

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
    """Dry-run and score one (arch x shape x mesh) cell at an ExecPoint,
    with on-disk memoization by `ExecPoint.key()`.

    `multi_pod` is `run_cell`'s: None counts one GPU, False / True rank 0
    of 16x16 / 2x16x16; the cell is named by its mesh.  `hbm_limit`
    defaults to the H100's 80 GB (`HW().hbm_bytes`), per card; the dry-run
    counts on fake tensors of `device`.  Points that run the same step
    share one dry-run: on one GPU those with the same `overrides()` (and
    in a train cell the same remat and microbatches), over a mesh also
    the same `sharding_mode` and `extra_rules`.  `n_compiles` counts the
    dry-runs.  `score_batch` scores a pool in `compile_workers` spawned
    processes (the dry-run is Python: threads would take turns at the
    GIL, and a mesh cell's process group is one a process)."""

    def __init__(self, arch_name: str, shape_name: str,
                 cache_dir: str | Path = CACHE_DIR,
                 hbm_limit: Optional[float] = None, device: str = "cuda",
                 *, multi_pod: Optional[bool] = None,
                 compile_workers: int = 1):
        from repro_torch.launch.dryrun import mesh_name

        self.arch_name = arch_name
        self.shape_name = shape_name
        self.multi_pod = multi_pod
        self.cell = f"{arch_name}_{shape_name}_{mesh_name(multi_pod)}"
        self.cache_dir = Path(cache_dir)
        self.dir = self.cache_dir / self.cell
        self.dir.mkdir(parents=True, exist_ok=True)
        self.hbm_limit = HW().hbm_bytes if hbm_limit is None else hbm_limit
        self.device = device
        self.compile_workers = max(1, int(compile_workers))
        self.n_compiles = 0

    def _step_key(self, pt: ExecPoint) -> Dict[str, Any]:
        """What of `pt` changes the step counted: the overrides, in a
        train cell remat and microbatches, over a mesh the rules."""
        from repro_torch.configs.shapes import shape_by_name
        key: Dict[str, Any] = pt.overrides()
        if shape_by_name(self.shape_name).mode == "train":
            key.update(remat=pt.remat, microbatches=pt.microbatches)
        if self.multi_pod is not None:
            key.update(sharding_mode=pt.sharding_mode,
                       extra_rules=[list(r) for r in pt.extra_rules])
        return key

    def evaluate(self, pt: ExecPoint) -> Dict[str, Any]:
        cache = self.dir / f"{pt.key()}.json"
        if cache.exists():
            return json.loads(cache.read_text())
        from repro_torch.launch.dryrun import run_cell

        # points that differ only where the step does not share the
        # dry-run of the first of them, which run_cell writes to
        # `<cell><tag>.json`
        tag = "_step" + hashlib.sha1(json.dumps(
            self._step_key(pt), sort_keys=True).encode()).hexdigest()[:12]
        step = self.dir / f"{self.cell}{tag}.json"
        if step.exists():
            rec = json.loads(step.read_text())
        else:
            rec = run_cell(self.arch_name, self.shape_name, self.dir,
                           multi_pod=self.multi_pod, device=self.device,
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

    def score_batch(self, pts: Sequence[ExecPoint]) -> List[float]:
        """Score a pool, its points' dry-runs on `compile_workers` spawned
        processes at once (each making its own fake process group for a
        mesh cell); the scores come back in pool order, equal to the
        serial scores (each point's record is a pure function of the
        point, and its cache file its own)."""
        pts = list(pts)
        if self.compile_workers <= 1 or len(pts) <= 1:
            return [self.score(p) for p in pts]
        todo = [i for i, p in enumerate(pts)
                if not (self.dir / f"{p.key()}.json").exists()]
        # one point a step key: two points of one step would run it twice
        firsts: Dict[str, int] = {}
        for i in todo:
            firsts.setdefault(json.dumps(self._step_key(pts[i]),
                                         sort_keys=True), i)
        payloads = [{"evaluator": self._recipe(), "point":
                     dataclasses.asdict(pts[i])} for i in firsts.values()]
        if payloads:
            from repro_torch.dse.parallel import ParallelExecutor
            done = ParallelExecutor(workers=min(self.compile_workers,
                                                len(payloads))).map(
                _score_point_task, payloads)
            self.n_compiles += sum(n for _, n in done)
        return [self.score(p) for p in pts]

    def _recipe(self) -> Dict[str, Any]:
        return {"arch_name": self.arch_name, "shape_name": self.shape_name,
                "cache_dir": str(self.cache_dir),
                "hbm_limit": self.hbm_limit, "device": self.device,
                "multi_pod": self.multi_pod}


def _score_point_task(payload: Dict[str, Any]) -> Tuple[float, int]:
    """A pool worker: one point's score through a `CellEvaluator` of its
    own (its dry-run written to the shared cache), and the dry-runs it
    ran."""
    pt = dict(payload["point"])
    pt["extra_rules"] = tuple(tuple(r) for r in pt["extra_rules"])
    ev = CellEvaluator(**payload["evaluator"])
    score = ev.score(ExecPoint(**pt))
    return score, ev.n_compiles


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
