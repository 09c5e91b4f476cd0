"""Graph data: containers and batching (``graphs``), the neighbour
sampler (``sampler``), synthetic generators (``synth``) and the
snapshot-consistent training pipeline over a live Weaver store
(``pipeline``)."""

from . import graphs, sampler, synth

__all__ = ["graphs", "sampler", "synth"]
