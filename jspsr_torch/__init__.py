"""jspsr_torch — the PyTorch/CUDA port of jspsr_tpu for NVIDIA Hopper.

The package mirrors ``jspsr_tpu``'s module layout and names. Inside it uses
torch's NCHW / OIHW layouts; its public entry points (``eval.inference``,
``cli.main``) keep the JAX package's HWC numpy interface. The deformable
conv forward runs as a hand-written CUDA kernel on the card
(``ops/csrc/deform_fwd.cu``); CPU tensors take its plain PyTorch version.
"""
