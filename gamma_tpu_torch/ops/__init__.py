"""Device-side numeric ops (PyTorch + hand-written CUDA kernels).

Counterpart of gamma_tpu/ops: plain functions on tensors that live on
whatever device the caller put them on.  Host code (index/, engine)
decides *what* to launch; these ops are the data plane.  The kernels
are the grouped SQ8 scan (ops/gsq.py), the grouped ADC scan
(ops/gadc.py) and the per-(query, probe) ADC scans (ops/adc.py);
everything else is plain torch.
"""
