"""Hand-written CUDA kernels of the port (sources in ``../csrc``).

Each kernel package has: kernel.py (ctypes binding of the CUDA source,
launch counters), ops.py (public wrapper: CUDA tensors to the kernel,
CPU tensors to the plain version), ref.py (plain PyTorch version).

  mv_visibility   — batched refinable-timestamp compares (``before``,
                    ``visibility``, ``before_pairs``): the multi-version
                    read path and the store's write validation
  segment_mp      — sorted-segment reductions for node programs (the
                    message-passing kernel comes with the GNN slice)
"""
