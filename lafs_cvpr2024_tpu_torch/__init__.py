"""LAFS on PyTorch and CUDA: the port of ``lafs_cvpr2024_tpu`` to an NVIDIA
H100 (Hopper, ``sm_90a``).

The layout mirrors the JAX package (``ops/``, ``models/``, ``train/``,
``eval/``, ``cli/``) so each module's counterpart is found by its path. The
package imports ``torch`` and never ``jax``; the hand-written kernels live
in ``csrc/`` and are built by ``_build`` at the first CUDA use.

Ported so far, each on one GPU: the embedding-serving path
(``python -m lafs_cvpr2024_tpu_torch.cli.serve_embeddings``), the SSL,
supervised and SimMIM training steps, and the SSL pretraining CLI
(``python -m lafs_cvpr2024_tpu_torch.cli.train_ssl``) with its input path
(``data/``). ROADMAP.md lists what is still to come.
"""
