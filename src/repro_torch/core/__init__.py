"""The analytical model of the paper's edge accelerator: workloads as
loop-dim layer chains, the memory hierarchy, dataflows, the cost model,
tiling, fusion and the Fig 8 stack, in pure Python.  Beside it, the
dry-run's measure of a program (``launch.dryrun``): ``opcount``, the
counter of its operations, and ``hloanalysis``, its collectives' traffic
and roofline."""
