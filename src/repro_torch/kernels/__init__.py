"""Hand-written CUDA kernels of the port (sources in ``../csrc``).

Each kernel package has: kernel.py (ctypes binding of the CUDA source,
launch counters), ops.py (public wrapper: CUDA tensors to the kernel,
CPU tensors to the plain version), ref.py (plain PyTorch version).

  mv_visibility   — batched refinable-timestamp compares (``before``,
                    ``visibility``, ``before_pairs``): the multi-version
                    read path and the store's write validation
  segment_mp      — fused message passing ``y[v] = sum x[u] @ W``
                    (``csrc/segment_mp.cu``) behind the GNN seam
                    ``models.mp.propagate_matmul``, plus the
                    sorted-segment reductions of node programs
  flash_attention — online-softmax attention with GQA, causal / window
                    masks and per-row key lengths
                    (``csrc/flash_attention.cu``) behind ``ops.mha``:
                    the LM's prefill and decode attention
  embedding_bag   — weighted row sums with -1 pads
                    (``csrc/embedding_bag.cu``) behind
                    ``ops.embedding_bag``: SASRec's item lookups
  bfs_round       — one BFS relaxation round (gather, +1, segment min,
                    changed flag; ``csrc/bfs_round.cu``) behind
                    ``ops.Rounds``: ``core.analytics.bfs_levels``; it
                    replaces no Pallas kernel
"""
