"""The parallel layer: ``balance`` (the row reorder of the balance command
and fix balance), ``rkspace`` (the r-space/k-space split on two CUDA
streams), and the multi-device decomposition over a process group:
``mesh`` (the group and its counted collectives), ``decomp`` (the cell
grid's slabs and pencils, the matrix engine's row blocks), ``halo`` (the
halo planes and the atoms' migration) and ``launch`` (a world of worker
processes, for the tests and the chip check)."""
