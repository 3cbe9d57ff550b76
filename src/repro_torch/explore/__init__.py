"""repro_torch.explore — design-space exploration over the cycle simulator.

Sweeps hardware design points (throughput targets through the lane
optimizer, schedule solvers, FIFO depth policies) for a compiled
pipeline, evaluates each with the population-batched cycle engine
(``repro_torch.hwsim.population``: every depth variant of a netlist in one
launch of the cycle kernel on the card, the plain version on the CPU),
and returns the area-vs-throughput Pareto front with the app's
hand-annotated design overlaid.

Entry points:
  ``HWDesign.explore(ExploreOptions(...))``   — method on a compiled design
  ``explore_app("flow", options)``            — by registered app name
  ``python -m repro_torch.explore --app flow`` — CLI (``--check`` for CI)
"""
from .engine import ExploreResult, explore_app, explore_design  # noqa: F401
from .pareto import DesignPoint, ParetoFront, freeze_depths  # noqa: F401
