"""HydraInfer core, host side: what the PyTorch serving engine needs of the
paper's scheduling system (DESIGN.md §1).

  request         - E/P/D request lifecycle + SLO accounting (§1.2, §8)
  costmodel       - Table-2 FLOPs/bytes + roofline + hardware profiles (§2)
  simulator       - only the role sets and ``DisaggConfig``/``RoleSpec``
                    (§3, §7.2); the discrete-event simulator stays in the
                    JAX package for now
  batch_scheduler - Algorithm-1 stage-level batching + baselines (§5)
  budgets         - TPOT-constrained token/image budget profiling (§6)
"""
