"""Measurement tools of the port: the kernel microbenchmark
(``bench_kernel_micro``) and the tensor-core Montgomery experiment
(``exp_mxu_mont``), each run as ``python3 -m masp_tpu_torch.tools.<name>``;
and bench.py's seeded circuit instances (``fixtures``)."""
