"""HydraInfer core, host side: the paper's scheduling system (DESIGN.md §1),
a copy of the JAX package's ``repro.core`` that imports neither JAX nor it.

  request         - E/P/D request lifecycle + SLO accounting (§1.2, §8)
  costmodel       - Table-2 FLOPs/bytes + roofline + hardware profiles (§2)
  simulator       - discrete-event cluster simulator, pull-based
                    migration, heterogeneous DisaggConfig (§3, §4, §7.2)
  batch_scheduler - Algorithm-1 stage-level batching + baselines (§5)
  budgets         - TPOT-constrained token/image budget profiling (§6)
  hybrid_epd      - exhaustive disaggregation search (§7)
  autotuner       - pruned/warm-started/cached/parallel search (§7.1)
  metrics         - TTFT/TPOT/attainment/goodput (§8)
"""
