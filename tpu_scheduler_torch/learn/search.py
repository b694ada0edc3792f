"""Seeded black-box search over the scheduling-policy weight surface.

Dependency-free cross-entropy method (CEM): sample a Gaussian population
over the ``ACTION_KNOBS`` box, evaluate each candidate as full sim episodes
(mean scorecard objective over training scenarios × seeds), refit the
Gaussian to the elite fraction, repeat.  The current mean is always
injected as candidate 0 of every generation, so the best-seen value is
monotone and generation 0 provably contains the default profile — the
``train-smoke`` floor.

Discipline the rest of the repo already enforces:

  * ONE seed: every draw comes from ``random.Random(f"{seed}:cem")``; the
    same ``SearchConfig`` reproduces the identical history in any process.
  * Pass gates are HARD constraints: an episode whose scorecard fails ANY
    gate (invariants, SLO, locality, availability, incremental, rebalance,
    policy floor) scores ``PASS_PENALTY``, so the optimizer cannot buy
    objective points with a broken run.
  * Held-out selection: the winning vector must beat the default profile
    on a DISJOINT seed set, else ``train_profile`` falls back to the
    default — a tuned artifact is never worse than what it replaces.
  * ``workers`` fans episode evaluation out over a thread pool (each
    episode is an independent single-threaded sim, the multi-replica
    harness pattern); results are keyed by candidate index, so the
    history is identical to the serial run.

Port: a copy of ``tpu_scheduler/learn/search.py``.  Every function that runs
episodes takes a ``device`` (``"cuda"`` by default, ``"cpu"`` when asked), and
each episode makes its own ``CudaBackend(device=device)``, as each JAX episode
makes its own NativeBackend.  The device stays out of ``SearchConfig``, so an
artifact's provenance echoes the JAX package's config unchanged.
"""

from __future__ import annotations

import random
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

from ..models.profiles import DEFAULT_PROFILE
from .env import ACTION_KNOBS, action_profile
from .objective import objective_from_card

__all__ = [
    "PASS_PENALTY",
    "SearchConfig",
    "TrainResult",
    "cem_optimize",
    "default_vector",
    "episode_objective",
    "evaluate_vectors",
    "held_out_table",
    "train_profile",
]

# Objective assigned to a candidate whose episode FAILS its scorecard pass
# gate — far below any reachable objective (components are bounded), so a
# gate-breaking vector can never enter the elite set.
PASS_PENALTY = -10.0


@dataclass(frozen=True)
class SearchConfig:
    """Everything a training run derives from — one config, one result."""

    scenarios: tuple = ("train-smoke",)  # registered scenario names to climb
    train_seeds: tuple = (0, 1)          # episode seeds the optimizer sees
    held_out_seeds: tuple = (101, 102)   # disjoint seeds for final selection
    generations: int = 3                 # CEM iterations
    population: int = 8                  # candidates per generation
    elite_frac: float = 0.25             # refit fraction (>= 1 candidate)
    init_sigma_frac: float = 0.25        # sigma0 as a fraction of each knob's span
    sigma_floor: float = 1e-3            # sigma never collapses below this
    seed: int = 0                        # the ONE seed (rng label "{seed}:cem")
    workers: int = 0                     # thread-pool width (0/1 = serial)


@dataclass
class TrainResult:
    """What ``train_profile`` hands to ``distill``: the chosen profile plus
    the full audit trail (history, train/held-out tables, fallback flag)."""

    profile: object = None               # the chosen SchedulingProfile
    vector: list = field(default_factory=list)
    improved: bool = False               # tuned beat default on held-out
    train_objective: float = 0.0         # best train-set mean objective
    default_train_objective: float = 0.0
    held_out: dict = field(default_factory=dict)    # scenario -> tuned mean
    default_held_out: dict = field(default_factory=dict)
    history: list = field(default_factory=list)     # per-generation stats
    config: SearchConfig = None


def cem_optimize(fn, lo, hi, mean0, sigma0, *, generations, population, elite_frac, rng, sigma_floor=1e-3):
    """Generic seeded CEM over a box (MAXIMIZATION).  ``fn`` takes the whole
    population (a list of vectors) and returns one value per candidate —
    batch-shaped so the caller owns any parallelism.  Returns
    ``(best_vec, best_val, history)``; candidate 0 of every generation is
    the current mean, so ``best_val`` is monotone in the mean's value."""
    # shape: (fn: obj, lo: obj, hi: obj, mean0: obj, sigma0: obj, generations: int, population: int, elite_frac: float, rng: obj, sigma_floor: float) -> obj
    dims = len(lo)
    mean = [float(m) for m in mean0]
    sigma = [max(sigma_floor, float(s)) for s in sigma0]
    n_elite = max(1, int(round(elite_frac * population)))
    best_vec: list | None = None
    best_val = float("-inf")
    history: list[dict] = []
    for g in range(generations):
        pop = [list(mean)]
        while len(pop) < population:
            pop.append([min(hi[d], max(lo[d], rng.gauss(mean[d], sigma[d]))) for d in range(dims)])
        vals = [float(v) for v in fn(pop)]
        # Ties break on candidate index — deterministic elite membership.
        ranked = sorted(range(len(pop)), key=lambda i: (-vals[i], i))
        elite = [pop[i] for i in ranked[:n_elite]]
        if vals[ranked[0]] > best_val:
            best_val = vals[ranked[0]]
            best_vec = list(pop[ranked[0]])
        mean = [sum(e[d] for e in elite) / n_elite for d in range(dims)]
        # Decaying extra noise on top of the elite std (Szita & Lorincz):
        # without it the elite variance collapses a sqrt-factor per
        # generation and the search freezes short of the optimum.  Linear
        # decay to zero at 70% of the run leaves the tail for fine refit.
        decay = max(0.0, 1.0 - (g + 1) / max(1.0, generations * 0.7))
        sigma = [
            max(
                sigma_floor,
                (sum((e[d] - mean[d]) ** 2 for e in elite) / n_elite) ** 0.5 + float(sigma0[d]) * decay,
            )
            for d in range(dims)
        ]
        history.append(
            {
                "generation": g,
                "best": round(vals[ranked[0]], 6),
                "elite_mean": round(sum(vals[i] for i in ranked[:n_elite]) / n_elite, 6),
                "mean": [round(m, 6) for m in mean],
                "sigma": [round(s, 6) for s in sigma],
            }
        )
    return best_vec, best_val, history


def default_vector() -> list:
    """The default profile's coordinates in ``ACTION_KNOBS`` order — the
    search's starting mean and the held-out baseline."""
    # shape: () -> obj
    return [float(getattr(DEFAULT_PROFILE, name)) for name, _lo, _hi in ACTION_KNOBS]


def episode_objective(vec, scenario, seed: int, device: str = "cuda") -> float:
    """One full episode under the candidate vector, over its own
    ``CudaBackend(device=device)``; the scorecard policy objective, or
    ``PASS_PENALTY`` when ANY pass gate fails."""
    # shape: (vec: obj, scenario: obj, seed: int, device: str) -> float
    from ..backends.cuda import CudaBackend
    from ..sim.harness import run_scenario

    profile = action_profile(DEFAULT_PROFILE, vec)
    card = run_scenario(scenario, seed=seed, profile=profile, backend=CudaBackend(device=device))
    if not card["pass"]:
        return PASS_PENALTY
    return objective_from_card(card)


def evaluate_vectors(vectors, scenarios, seeds, workers: int = 0, device: str = "cuda") -> list:
    """Mean episode objective per candidate over scenarios × seeds.
    ``workers > 1`` fans the independent episodes over a thread pool;
    results are folded by (candidate, scenario, seed) index, so the output
    is identical to the serial evaluation."""
    # shape: (vectors: obj, scenarios: obj, seeds: obj, workers: int, device: str) -> obj
    jobs = [
        (i, sc, seed)
        for i, _vec in enumerate(vectors)
        for sc in scenarios
        for seed in seeds
    ]
    if workers and workers > 1:
        with ThreadPoolExecutor(max_workers=int(workers)) as pool:
            scores = list(pool.map(lambda j: episode_objective(vectors[j[0]], j[1], j[2], device), jobs))
    else:
        scores = [episode_objective(vectors[i], sc, seed, device) for i, sc, seed in jobs]
    per = len(scenarios) * len(seeds)
    return [round(sum(scores[i * per : (i + 1) * per]) / per, 6) for i in range(len(vectors))]


def held_out_table(vec, scenarios, seeds, workers: int = 0, device: str = "cuda") -> dict:
    """Per-scenario mean objective on the held-out seed set (the numbers
    the PR/bench report)."""
    # shape: (vec: obj, scenarios: obj, seeds: obj, workers: int, device: str) -> obj
    out = {}
    for sc in scenarios:
        vals = [episode_objective(vec, sc, seed, device) for seed in seeds]
        out[sc] = round(sum(vals) / len(vals), 6) if vals else 0.0
    return out


def train_profile(cfg: SearchConfig, log=None, device: str = "cuda") -> TrainResult:
    """The full training run: CEM on the train seeds, selection on the
    held-out seeds, fall back to the default profile if the tuned vector
    does not beat it there.  Reproducible from ``cfg`` alone (``device``
    says where the episodes run, not what they compute)."""
    # shape: (cfg: obj, log: obj, device: str) -> obj
    say = log or (lambda _msg: None)
    lo = [k[1] for k in ACTION_KNOBS]
    hi = [k[2] for k in ACTION_KNOBS]
    mean0 = default_vector()
    sigma0 = [cfg.init_sigma_frac * (hi_v - lo_v) for lo_v, hi_v in zip(lo, hi)]
    rng = random.Random(f"{cfg.seed}:cem")

    def fn(pop):
        return evaluate_vectors(pop, cfg.scenarios, cfg.train_seeds, workers=cfg.workers, device=device)

    default_train = evaluate_vectors([mean0], cfg.scenarios, cfg.train_seeds, workers=cfg.workers, device=device)[0]
    say(f"generation-0 default objective (train): {default_train}")
    best_vec, best_val, history = cem_optimize(
        fn,
        lo,
        hi,
        mean0,
        sigma0,
        generations=cfg.generations,
        population=cfg.population,
        elite_frac=cfg.elite_frac,
        rng=rng,
        sigma_floor=cfg.sigma_floor,
    )
    say(f"best train objective after {cfg.generations} generations: {round(best_val, 6)}")

    tuned_held = held_out_table(best_vec, cfg.scenarios, cfg.held_out_seeds, workers=cfg.workers, device=device)
    default_held = held_out_table(mean0, cfg.scenarios, cfg.held_out_seeds, workers=cfg.workers, device=device)
    tuned_mean = sum(tuned_held.values()) / len(tuned_held)
    default_mean = sum(default_held.values()) / len(default_held)
    improved = tuned_mean > default_mean
    chosen = best_vec if improved else mean0
    say(f"held-out: tuned {round(tuned_mean, 6)} vs default {round(default_mean, 6)} -> {'tuned' if improved else 'default (fallback)'}")
    profile = action_profile(DEFAULT_PROFILE.with_(name="tuned" if improved else "default"), chosen)
    return TrainResult(
        profile=profile,
        vector=[round(float(x), 6) for x in chosen],
        improved=improved,
        train_objective=round(best_val, 6),
        default_train_objective=round(default_train, 6),
        held_out=tuned_held,
        default_held_out=default_held,
        history=history,
        config=cfg,
    )
