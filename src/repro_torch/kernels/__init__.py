"""Hand-written Hopper kernels of the port and their plain versions.

  ref.py          plain PyTorch oracles (counterpart of repro.kernels.ref)
  rbf_matvec.py   launch wrapper of csrc/rbf_matvec.cu (replaces the Pallas
                  kernel repro/kernels/rbf_matvec.py:rbf_matvec_pallas)
  nll_grad.py     launch wrapper of csrc/nll_grad.cu (replaces the Pallas
                  kernel repro/kernels/nll_grad.py:nll_grad_pallas)
  rbf_gram.py     launch wrapper of csrc/rbf_gram.cu (replaces the Pallas
                  kernel repro/kernels/rbf_gram.py:rbf_gram_pallas)
  cholupdate.py   launch wrapper of csrc/cholupdate.cu (replaces the Pallas
                  kernel repro/kernels/cholupdate.py:cholupdate_pallas)
  flash_attention.py
                  launch wrapper of csrc/flash_attention.cu (replaces the
                  Pallas kernel repro/kernels/flash_attention.py:
                  flash_attention_pallas), and FlashAttentionFunction
                  with the plain backward of repro/kernels/flash_jnp.py
  ops.py          public ops with the reference's signatures
  _build.py       nvcc build of csrc/*.cu and the ctypes loader

Nothing here builds or loads CUDA code at import time.
"""
