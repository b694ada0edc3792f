"""The reproducer corpus: shrunk plans checked into ``tests/fuzz_corpus/``.

Each ``*.json`` entry is a complete, self-verifying replay: the plan, the
seed, and the expected outcome (fingerprint, pass verdict, violation names,
and optional dotted-path ``pins`` into the scorecard).  Tier-1 replays every
entry on every test run — a corpus entry is a bug (or a near-miss) pinned
forever, bit-identically, with at most :data:`~.plan.MAX_OPS` fault ops.

Port: a copy of ``tpu_scheduler/sim/fuzz/corpus.py``; ``replay_entry``
takes the episode's backend.  The corpus is the JAX package's
(``tests/fuzz_corpus/``), read as data: a bit-identical replay here is a
replay of the JAX sim's fingerprint.
"""

from __future__ import annotations

import json
import os

from .oracle import card_value, run_plan
from .plan import MAX_OPS, FaultPlan, plan_from_json

__all__ = ["ENTRY_FIELDS", "load_corpus", "replay_entry"]

# Closed corpus-entry schema (the JAX package's, so its corpus files load here).
ENTRY_FIELDS = ("name", "note", "seed", "expect", "plan")


# shape: (path: str) -> obj
def load_entry(path: str) -> dict:
    with open(path, encoding="utf-8") as fh:
        raw = json.load(fh)
    for field in ENTRY_FIELDS:
        if field not in raw:
            raise ValueError(f"corpus entry {path} missing field {field!r}")
    plan = plan_from_json(json.dumps(raw["plan"]))
    if len(plan.ops) > MAX_OPS:
        raise ValueError(f"corpus entry {path} has {len(plan.ops)} ops, cap is {MAX_OPS}")
    return {
        "name": str(raw["name"]),
        "note": str(raw["note"]),
        "seed": int(raw["seed"]),
        "plan": plan,
        "expect": dict(raw["expect"]),
    }


# shape: (corpus_dir: str) -> obj
def load_corpus(corpus_dir: str) -> list[dict]:
    """All entries, sorted by filename for a deterministic replay order."""
    if not os.path.isdir(corpus_dir):
        return []
    out = []
    for fname in sorted(os.listdir(corpus_dir)):
        if fname.endswith(".json"):
            out.append(load_entry(os.path.join(corpus_dir, fname)))
    return out


# shape: (entry: obj) -> (bool, obj, obj)
def replay_entry(entry: dict, backend=None) -> tuple[bool, list[str], dict]:
    """Re-run one corpus entry from (plan, seed) and check every
    expectation: fingerprint equality IS the bit-identity assertion."""
    card, violations = run_plan(entry["plan"], entry["seed"], backend=backend)
    expect = entry["expect"]
    problems: list[str] = []
    if card["fingerprint"] != expect["fingerprint"]:
        problems.append(f"fingerprint drifted: {card['fingerprint']} != {expect['fingerprint']}")
    if bool(card["pass"]) != bool(expect["pass"]):
        problems.append(f"pass verdict drifted: {card['pass']} != {expect['pass']}")
    if list(violations) != list(expect.get("violations", [])):
        problems.append(f"violations drifted: {violations} != {expect.get('violations')}")
    for path, want in sorted(expect.get("pins", {}).items()):
        got = card_value(card, path)
        if got != want:
            problems.append(f"pin {path} drifted: {got!r} != {want!r}")
    return (not problems), problems, card


# shape: (entry_name: str, note: str, plan: obj, seed: int, card: obj, violations: obj) -> obj
def entry_for(entry_name: str, note: str, plan: FaultPlan, seed: int, card: dict, violations: list, pins: dict | None = None) -> dict:
    """Build the JSON body for a new corpus entry from a finished run."""
    out = {
        "name": entry_name,
        "note": note,
        "seed": int(seed),
        "expect": {
            "fingerprint": card["fingerprint"],
            "pass": bool(card["pass"]),
            "violations": list(violations),
        },
        "plan": plan.to_json(),
    }
    if pins:
        out["expect"]["pins"] = dict(sorted(pins.items()))
    assert tuple(out) == ENTRY_FIELDS, "corpus entry drifted from ENTRY_FIELDS"
    return out
