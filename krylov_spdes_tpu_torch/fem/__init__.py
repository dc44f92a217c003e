"""FEM layer of the port (mirrors krylov_spdes_tpu/fem)."""

from .mesh import get_mesh, element_geometry, TriMesh  # noqa: F401
from .bc import get_dirichlet_inds, append_bc, DirichletMaps  # noqa: F401
from .assembly import (prepare_elliptic_assembly,  # noqa: F401
                       do_isotropic_elliptic_assembly, assemble_values,
                       EllipticAssembly, get_mass_matrix)
from .stencil_assembly import (prepare_stencil_assembly,  # noqa: F401
                               stencil_assemble, make_stencil_operator)
from .partition import mesh_partition  # noqa: F401
from .dd import (DDAssemblyPlan, DDPartition, assemble_dd_values,  # noqa: F401
                 domain_decompose_rhs, get_partition, prepare_dd_assembly,
                 set_subdomains)
from .dd_stencil import (DDStencilPlan, assemble_dd_values_stencil,  # noqa: F401
                         condense_dd_stencil, prepare_dd_stencil_assembly)
