"""Hand-written Hopper kernels and their plain PyTorch versions.

- :mod:`.binary_matmul` — fused grouped low-rank binary matmul
- :mod:`.paged_attention` — paged gather decode attention
- :mod:`.megakernel` — decode-step megakernel (QKV → attention → wo)
- :mod:`.ops` — the dispatch layer (:class:`.ops.KernelPolicy`)
- :mod:`.ref` — the plain oracles
"""
