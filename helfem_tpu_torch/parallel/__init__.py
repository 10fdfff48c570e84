"""Multi-device runs of the port (helfem_tpu's parallel/mesh.py on
torch.distributed): one process per rank, a process group of ndev ranks,
the L, channel, step and element axes of the Fock build split over the
ranks and their partials summed by all_reduce (mesh.py), and the process
launch (launch.py)."""
