"""Measurement tools of the port: the kernel microbenchmark
(``bench_kernel_micro``) and the tensor-core Montgomery experiment
(``exp_mxu_mont``), each run as ``python3 -m masp_tpu_torch.tools.<name>``;
bench.py's seeded circuit instances (``fixtures``); and a seeded wallet over
the transaction builder (``wallet``), which chip_smoke.py's phase tx drives."""
