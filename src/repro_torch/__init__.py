"""PyTorch/CUDA port of the SkyWalker replica stack for NVIDIA Hopper.

A second package beside the JAX reference `repro`, laid out like it:
`configs/`, `models/`, `kernels/` (hand-written CUDA for sm_90a, each
beside its plain PyTorch version), `replica/`, `tenancy/` and `serving/`.
It imports nothing of JAX or of `repro`: the framework-free modules it
needs are copies, each marked with its origin.

Entry points run on the card (`device="cuda"`) unless the caller asks for
the CPU, where every kernel call takes its plain version.
"""
