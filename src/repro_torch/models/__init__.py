"""Model zoo of the port: GNNs over the message-passing seam (the LM and
recsys models come with later slices)."""

from . import gnn, mp

__all__ = ["gnn", "mp"]
