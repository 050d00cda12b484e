"""Image operations of the port. The kernels sit behind ``demosaic`` (K1,
K11), ``sep_rank`` (K2, and K4 on narrow frames), ``print_encode`` (K3),
``sep_conv`` (K5, K6), ``grain`` (K7, K8, K9), ``pyramid`` (K10, K12, K13)
and ``halation`` (K14)."""
