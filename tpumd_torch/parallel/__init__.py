"""The parallel layer on one card: ``balance`` (the row reorder of the
balance command and fix balance) and ``rkspace`` (the r-space/k-space
split on two CUDA streams).  The multi-device decomposition of
tpumd/parallel/mesh.py is not ported yet."""
