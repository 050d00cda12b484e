"""Image operations of the port; kernels K1-K3 sit behind ``demosaic``,
``sep_rank`` and ``print_encode``, K10 and K12 behind ``pyramid``, K14
behind ``halation``."""
