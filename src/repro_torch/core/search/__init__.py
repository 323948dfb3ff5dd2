"""Batched ask/tell search engines for design-space exploration.

The paper casts accelerator design as a multi-dimensional optimization
problem solved by a search loop over an analytical cost model (§4.3,
Algorithm 1).  Every engine is an ask/tell `Optimizer` (see `base.py`)::

    class Optimizer:
        def propose(self) -> List[config]:
            '''Next pool of candidates to score (may be empty to stop).'''
        def observe(self, pool, scores: np.ndarray) -> None:
            '''Scores for the pool just proposed; update internal state.'''
        @property
        def done(self) -> bool:
            '''True once converged / budget exhausted.'''

and `run_search(engine, evaluator)` drives it::

    while not engine.done:
        pool = engine.propose()
        scores = evaluator(pool)        # ONE batched cost-model call
        engine.observe(pool, scores)

The shared `Evaluator` memoizes in a vectorized row cache on the host and
scores cache misses on its device, through `FusedTorchScorer` or
`performance_gops`' broadcast pass (its `backend`).  Pools are array-native
`ConfigBatch` populations built from `SpaceCodec` index arrays and
validity-repaired in bulk by `repair_for_peaks_many`.  An evaluator with a
vector objective (`ParetoObjective`) hands back [N, M] rows; `make_engine`
installs its `scalarize` as the engine's `scalarizer`.

Engines
=======

============  ==========================================================
``greedy``    Multi-step greedy, Algorithm 1 verbatim (bit-for-bit with
              the JAX package's engine at a fixed seed).
``anneal``    Simulated annealing: `chains` parallel Metropolis walkers,
              single-variable moves, geometric cooling.
``genetic``   Evolutionary search over the power-of-two domains:
              tournament selection, uniform crossover, random-reset
              mutation, elitism; population kept as a struct-of-arrays
              index matrix (`SpaceCodec`).
``random``    Uniform random draws (validity-repaired) — the baseline,
              and the engine that scores large pools.
``tpe``       Tree-structured Parzen Estimator: per-dimension smoothed
              categorical densities over the codec index columns, good/
              bad split at the `gamma` quantile, batched candidates
              ranked by EI ratio.
``nsga2``     NSGA-II: fast non-dominated sort + crowding distance over
              (GOPS, -area) rows (or an evaluator's [N, M] objective
              rows), (mu + lambda) elitism, offspring repaired in bulk.
============  ==========================================================

Each engine is a numpy copy of the JAX package's, proposal for proposal at
a fixed seed; `synthetic` holds the closed-form problems with known optima
that test them.  `FunctionEvaluator` gives the same pool interface over an
arbitrary scalar scorer (the execution space's dry-runs), and `partition`
the assignment/split combinatorics of multi-engine compositions.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, List, Optional, Union

from repro_torch.core.search.anneal import AnnealOptimizer
from repro_torch.core.search.base import (DiscreteSpace, Optimizer,
                                          SearchResult, SpaceCodec,
                                          pack_config, pareto_front_indices,
                                          repair_many_with, repair_with,
                                          run_search, unpack_config)
from repro_torch.core.search.evaluator import (Evaluator, FunctionEvaluator,
                                               config_key)
from repro_torch.core.search.genetic import GeneticOptimizer
from repro_torch.core.search.greedy import GreedyOptimizer
from repro_torch.core.search.nsga2 import NSGA2Optimizer
from repro_torch.core.search.partition import (Partition,
                                               enumerate_assignments,
                                               enumerate_partitions,
                                               enumerate_splits,
                                               group_members, tier_shares)
from repro_torch.core.search.random_search import RandomSearchOptimizer
from repro_torch.core.search.tpe import TPEOptimizer

__all__ = [
    "Optimizer", "SearchResult", "run_search", "SpaceCodec",
    "DiscreteSpace", "pareto_front_indices", "repair_with",
    "repair_many_with", "pack_config", "unpack_config", "Evaluator",
    "FunctionEvaluator", "config_key", "Partition", "enumerate_assignments",
    "enumerate_splits", "enumerate_partitions", "tier_shares",
    "group_members",
    "GreedyOptimizer", "AnnealOptimizer", "GeneticOptimizer",
    "RandomSearchOptimizer", "TPEOptimizer", "NSGA2Optimizer", "ENGINES",
    "EngineSpec", "filter_kwargs", "make_engine", "optimize_for_app",
    "multi_step_greedy",
]

ENGINES: Dict[str, type] = {
    "greedy": GreedyOptimizer,
    "anneal": AnnealOptimizer,
    "genetic": GeneticOptimizer,
    "random": RandomSearchOptimizer,
    "tpe": TPEOptimizer,
    "nsga2": NSGA2Optimizer,
}

EngineSpec = Union[str, Callable[..., Optimizer]]


def filter_kwargs(fn: Callable, kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """Drop keyword arguments `fn` does not accept (superset tolerance:
    callers may pass a union of every engine's knobs; each callee takes
    what it understands).  No-op if `fn` takes **kwargs."""
    params = inspect.signature(fn).parameters
    if any(p.kind == inspect.Parameter.VAR_KEYWORD for p in params.values()):
        return dict(kwargs)
    return {k: v for k, v in kwargs.items() if k in params}


def make_engine(engine: EngineSpec, space, evaluator, **kwargs) -> Optimizer:
    """Instantiate an engine from a name or factory.

    Keyword arguments the engine's constructor does not accept are dropped
    (`filter_kwargs`), so callers can pass a superset (e.g. greedy's
    `k`/`patience` alongside genetic's `population`)."""
    if isinstance(engine, str):
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}; available: "
                             f"{sorted(ENGINES)}")
        factory = ENGINES[engine]
    else:
        factory = engine
    eng = factory(space, evaluator, **filter_kwargs(factory, kwargs))
    # vector-objective evaluators (repro_torch.dse ParetoObjective) expose a
    # scalarize hook; install it so engines reduce [N, M] rows themselves
    # when driven outside run_search
    if getattr(eng, "scalarizer", None) is None:
        obj = getattr(evaluator, "objective", None)
        if obj is not None and hasattr(obj, "scalarize"):
            eng.scalarizer = evaluator.scalarize
    return eng


def optimize_for_app(
    stream,
    space,
    k: int = 3,
    restarts: int = 4,
    seed: int = 0,
    peak_weight_bits: int = 0,
    peak_input_bits: int = 0,
    max_rounds: int = 40,
    engine: EngineSpec = "greedy",
    engine_kwargs: Optional[Dict[str, Any]] = None,
    evaluator: Optional[Evaluator] = None,
    device="cuda",
) -> SearchResult:
    """Multi-start wrapper: the paper restarts from random initial points to
    avoid local optima; the evaluated sets merge so top-10 % candidate
    selection (§5.1) sees every scored configuration.

    One `Evaluator` (and hence one cache) is shared across all restarts,
    so configurations revisited by different starts are scored exactly
    once.  `device` places a new evaluator; a given `evaluator` keeps its
    own."""
    if evaluator is None:
        evaluator = Evaluator.for_space(stream, space,
                                        peak_weight_bits=peak_weight_bits,
                                        peak_input_bits=peak_input_bits,
                                        device=device)
    kw: Dict[str, Any] = {"k": k, "patience": 3, "max_rounds": max_rounds}
    kw.update(engine_kwargs or {})
    seed = kw.pop("seed", seed)       # engine_kwargs may override the base
    # restart results reduce through SearchResult.merge (earliest-max
    # incumbent, logs concatenated in restart order)
    results: List[SearchResult] = []
    for r in range(restarts):
        eng = make_engine(engine, space, evaluator,
                          seed=seed + 1000 * r, **kw)
        results.append(run_search(eng, evaluator))
    return SearchResult.merge(results, evaluator=evaluator)


def multi_step_greedy(
    stream,
    space,
    k: int = 3,
    delta_p_threshold: float = 1e-3,
    max_rounds: int = 40,
    seed: int = 0,
    init: Optional[Any] = None,
    peak_weight_bits: int = 0,
    peak_input_bits: int = 0,
    pool_cap: int = 20000,
    patience: int = 1,
    device="cuda",
) -> SearchResult:
    """Algorithm 1, single start (paper §4.3).  `k` trades off optimality
    and per-round cost."""
    evaluator = Evaluator.for_space(stream, space,
                                    peak_weight_bits=peak_weight_bits,
                                    peak_input_bits=peak_input_bits,
                                    device=device)
    engine = GreedyOptimizer(space, evaluator, k=k,
                             delta_p_threshold=delta_p_threshold,
                             max_rounds=max_rounds, seed=seed, init=init,
                             pool_cap=pool_cap, patience=patience)
    return run_search(engine, evaluator)
