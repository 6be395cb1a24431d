"""Multi-device sharding (``mesh``) and the multi-process runtime
(``distributed``): the twins of masp_tpu/parallel."""
