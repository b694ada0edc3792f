"""Policy learning — gym-style sim episodes, seeded black-box search, and
zero-cost distillation into the fused score path.

The subsystem has four layers:

  ``objective.py``  — the scalar reward surface: one number per scorecard,
                      computed from existing blocks only (SLO attainment,
                      packing efficiency, gang locality, churn penalty)
                      with a closed, documented weight schema.
  ``env.py``        — ``SchedulerEnv``: step/observe/act episodes over
                      ``sim/harness.py`` on the existing ``VirtualClock``;
                      every episode reproducible from one seed.
  ``search.py``     — dependency-free seeded cross-entropy search over the
                      ``SchedulingProfile`` weight vector, train seeds for
                      climbing and a held-out seed set for selection.
  ``distill.py``    — the winning vector exported as a versioned JSON
                      artifact (``learn/profiles/``), loadable via
                      ``SchedulingProfile.from_file`` / ``--profile-file``
                      and riding the existing fused choose path at ZERO
                      inference cost.

This ``__init__`` stays import-light on purpose: ``sim/scorecard.py``
imports ``learn.objective`` for every verdict, and must not drag the env
or search machinery (or torch, via the backends) into that path.

Port: a copy of ``tpu_scheduler/learn/``.  The episodes run the port's
simulator over ``CudaBackend``: on the card unless ``device="cpu"`` (``--device
cpu``) is asked for.  The checked-in artifacts under ``learn/profiles/`` are
byte-for-byte copies of the JAX package's.
"""

from __future__ import annotations

__all__: list[str] = []
