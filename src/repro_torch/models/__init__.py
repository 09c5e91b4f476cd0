"""Model zoo of the port: GNNs over the message-passing seam, the dense
LMs (``transformer`` over ``layers``, attention on the flash_attention
kernel) and SASRec (item lookups on the embedding_bag kernel)."""

from . import gnn, layers, mp, sasrec, transformer

__all__ = ["gnn", "layers", "mp", "sasrec", "transformer"]
