"""Device-side numeric ops (PyTorch + hand-written CUDA kernels).

Counterpart of gamma_tpu/ops: plain functions on tensors that live on
whatever device the caller put them on.  Host code (index/, engine)
decides *what* to launch; these ops are the data plane.  The grouped
SQ8 scan (ops/gsq.py) is the one kernel of this slice; everything else
is plain torch.
"""
