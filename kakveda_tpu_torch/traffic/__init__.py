"""Record-replay traffic harness — scenario storms, chaos timelines,
SLO-gated graceful degradation.

Port of ``kakveda_tpu/traffic/``: the same generators (same seed, same
events), log format, replay accounting, chaos actions and SLO gates.

This package is the load *generator* that turns "we degrade gracefully" into a
regression-gated claim: seeded scenario generators produce the load shapes
that actually break systems (hot-key skew, diurnal waves, failure storms,
adversarial near-duplicate floods), an open-loop replayer drives them
through the real HTTP stack at a controllable speed factor, a chaos
timeline arms `core/faults.py` sites and kills fleet replicas at scheduled
offsets mid-run, and declarative SLO gates assert the degradation contract
(bounded warn p95, sheds confined to sheddable classes, zero hung
requests, zero lost warns, ladder recovery after the storm).

Modules (``python -m kakveda_tpu_torch.cli traffic`` is the operator view):

* :mod:`capture`   — flight-recorder request timelines ⇄ replayable JSONL
  traffic logs (`cli traffic record`).
* :mod:`scenarios` — seeded generators; same seed → identical arrival
  schedule and app-key sequence.
* :mod:`replay`    — open-loop replay + chaos-timeline executor
  (`traffic replay`, `traffic storm`).
* :mod:`slo`       — per-scenario declarative gates and their evaluation,
  folded into the `storm` drill's verdict.
"""

from kakveda_tpu_torch.traffic.capture import (  # noqa: F401
    from_flightrecorder,
    read_log,
    write_log,
)
from kakveda_tpu_torch.traffic.replay import (  # noqa: F401
    ReplayResult,
    replay,
    run_chaos,
    run_scenario,
)
from kakveda_tpu_torch.traffic.scenarios import SCENARIOS, Scenario, make_scenario  # noqa: F401
from kakveda_tpu_torch.traffic.slo import SLO, SLOReport, evaluate  # noqa: F401
