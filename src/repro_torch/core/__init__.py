"""The analytical model of the paper's edge accelerator: workloads as
loop-dim layer chains, the memory hierarchy, dataflows, the cost model,
tiling, fusion and the Fig 8 stack.  Pure Python; no tensor code."""
