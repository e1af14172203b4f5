"""Device-side numeric ops (PyTorch + hand-written CUDA kernels).

Counterpart of gamma_tpu/ops: plain functions on tensors that live on
whatever device the caller put them on.  Host code (index/, engine)
decides *what* to launch; these ops are the data plane.  The kernels
are the grouped SQ8 scan (ops/gsq.py), the grouped ADC scan
(ops/gadc.py), the per-(query, probe) ADC scans (ops/adc.py) and the
rerank's row gather (ops/gather_rows.py); everything else, the dense
scan's GEMM and top-k among it (ops/dense_scan.py), is plain torch.
"""
