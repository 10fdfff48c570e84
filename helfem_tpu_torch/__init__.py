"""helfem_tpu_torch: the PyTorch/CUDA port of helfem_tpu.

The paths of helfem_tpu carried to PyTorch so far, with hand-written CUDA
kernels (`kernels/`, sources in `csrc/`): atomic restricted Hartree-Fock
(radial Coulomb and exchange kernels); diatomic and atomic LDA, GGA and
meta-GGA DFT (diatomic radial Coulomb, XC grid fields and XC Fock kernels,
the last two with a tau mode); diatomic
restricted Hartree-Fock and the PBE0 hybrid (the occupied-orbital and the
dense diatomic exchange kernels); and the f64-ablation matmul probes
(`tools/f64_ablation.py`). helfem_tpu stays the reference the port is tested
against; this package imports torch and never jax or helfem_tpu.

Conventions: every tensor is torch.float64 (gidx int32), every function that
creates tensors takes an explicit `device`, and no global default dtype is
set. A CUDA tensor goes through the kernels; a CPU tensor through their plain
PyTorch versions.
"""

__version__ = "0.1.0"
