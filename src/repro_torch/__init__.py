"""``repro_torch`` — the PyTorch/CUDA port of the DeMM packed-sparse system.

Mirrors the sub-package layout of the JAX reference package ``repro`` (which
it never imports): ``core`` (formats, pruning, the sparse linear), ``kernels``
(hand-written Hopper kernels with their plain PyTorch versions), ``models``,
``quant``, ``serve``, ``launch``, ``obs``, ``configs``, ``spec``, ``tune``.
The ported slice is packed greedy/sampled decode of a dense decoder LM
(``python -m repro_torch.launch.serve``); see README.md, "PyTorch/H100 port".
"""
