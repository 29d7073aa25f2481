"""raft_tpu_torch.planner — deadline-aware adaptive query planning.

Counterpart of ``raft_tpu.planner``: turns the measurements (per-batch
device time, the roofline floors of ``obs.costs``, per-request deadlines,
recall against an exact oracle) into control:

- :mod:`~raft_tpu_torch.planner.adaptive` — the committed QPS-vs-recall
  Pareto-frontier artifact (``PARETO_<platform>.json``), the pure
  :func:`~raft_tpu_torch.planner.adaptive.choose_operating_point` policy,
  and the EWMA calibration the serving engine feeds from each batch's
  device time;
- :mod:`~raft_tpu_torch.planner.sweep` — the offline parameter sweep
  (``python -m raft_tpu_torch.planner.sweep``): per family/shape/k, every
  grid point measured through the serving handles' ``search_with``
  against an exact oracle and pruned to the non-dominated frontier.

Layering: ``adaptive`` is registry-only (no torch import), so the serving
hot path loads frontiers cheaply; ``sweep`` imports the neighbor families.
"""

from raft_tpu_torch.planner.adaptive import (ADAPTIVE_REASONS, PARETO_SCHEMA,
                                       AdaptivePlanner, Calibration, Choice,
                                       Frontier, OperatingPoint,
                                       adaptive_choice_counts,
                                       choose_operating_point,
                                       frontier_metrics, hypervolume,
                                       load_frontier, pareto_prune,
                                       record_choice)

__all__ = [
    "ADAPTIVE_REASONS",
    "PARETO_SCHEMA",
    "AdaptivePlanner",
    "Calibration",
    "Choice",
    "Frontier",
    "OperatingPoint",
    "adaptive_choice_counts",
    "choose_operating_point",
    "frontier_metrics",
    "hypervolume",
    "load_frontier",
    "pareto_prune",
    "record_choice",
]
