"""rabbitkssd: a GPU k-mer substring-space sketch & distance engine.

A from-scratch JAX/XLA re-design with the full capabilities of
RabbitKSSD (k-mer substring space decomposition genome distance
estimation): shuffle / sketch / alldist / dist / union / sub / convert /
merge / info, with byte-compatible on-disk formats.
"""

__version__ = "0.1.0"

from .params import KssdParams, params_from_id  # noqa: F401
from .formats import Sketch, SketchInfo, SketchSet  # noqa: F401
