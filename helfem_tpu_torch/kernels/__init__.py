"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.

A wrapper sends CPU tensors to the plain version and CUDA tensors to its
kernel, or raises: there is no fallback from the kernel to the plain version
and no switch to force either. `launches` counts each wrapper's kernel
launches. The kernels are built from csrc/ at first use (_build.py).
"""

from helfem_tpu_torch.kernels._common import (
    band_table,
    check_gidx,
    launches,
    owner_table,
    reset_launches,
)
from helfem_tpu_torch.kernels.dia_xc_fields import dia_xc_fields, dia_xc_fields_plain
from helfem_tpu_torch.kernels.dia_xc_fock import dia_xc_fock, dia_xc_fock_plain
from helfem_tpu_torch.kernels.matmul_probe import (
    matmul_dd,
    matmul_dd_plain,
    matmul_f32,
    matmul_f32_plain,
)
from helfem_tpu_torch.kernels.radial_coulomb import radial_coulomb, radial_coulomb_plain
from helfem_tpu_torch.kernels.radial_coulomb_dia import (
    radial_coulomb_dia,
    radial_coulomb_dia_plain,
)
from helfem_tpu_torch.kernels.radial_erfc_exchange import (
    radial_erfc_exchange,
    radial_erfc_exchange_plain,
)
from helfem_tpu_torch.kernels.radial_exchange import (
    radial_exchange,
    radial_exchange_pairwise_plain,
    radial_exchange_plain,
)
from helfem_tpu_torch.kernels.radial_exchange_dia import (
    radial_exchange_dia,
    radial_exchange_dia_occ,
    radial_exchange_dia_occ_plain,
    radial_exchange_dia_plain,
)
from helfem_tpu_torch.kernels.refine_eig import refine_eig, refine_eig_plain

__all__ = ["band_table", "check_gidx", "launches", "owner_table", "reset_launches", "radial_coulomb",
           "radial_coulomb_plain", "radial_exchange", "radial_exchange_plain",
           "radial_exchange_pairwise_plain", "radial_erfc_exchange",
           "radial_erfc_exchange_plain", "radial_coulomb_dia", "radial_coulomb_dia_plain",
           "dia_xc_fields", "dia_xc_fields_plain", "dia_xc_fock", "dia_xc_fock_plain",
           "radial_exchange_dia_occ", "radial_exchange_dia_occ_plain",
           "radial_exchange_dia", "radial_exchange_dia_plain", "matmul_f32",
           "matmul_f32_plain", "matmul_dd", "matmul_dd_plain", "refine_eig", "refine_eig_plain"]
