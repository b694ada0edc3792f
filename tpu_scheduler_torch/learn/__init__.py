"""Policy learning — in the port, only the objective so far.

``objective.py`` is a copy of ``tpu_scheduler/learn/objective.py``: the
scorecard's ``policy`` block (``sim/scorecard.py``) folds every verdict
into its one scalar.  The episodes, the seeded search and the distillation
(``env.py``, ``search.py``, ``distill.py``) and ``sim train`` wait for
ROADMAP Queue 1 item 9.
"""

from __future__ import annotations

__all__: list[str] = []
