"""libecc_tpu_torch: the PyTorch / CUDA port of libecc_tpu for NVIDIA Hopper.

Batched elliptic-curve arithmetic on ``int32[K, N]`` limb tensors, with the
hot operations as hand-written CUDA kernels (``csrc/``, bound in
``ops/cuda/``). So far it covers batched ECDSA verification on the
short-Weierstrass curves (P-256 first): ``sig.ecdsa.verify_batch``,
``verify_batch_async`` and ``verify_batches``; and batched Ed25519
verification (RFC 8032 ed25519, ed25519ctx, ed25519ph):
``sig.eddsa.verify_batch``. It imports neither JAX nor the ``libecc_tpu``
package.
"""

__version__ = "0.1.0"
