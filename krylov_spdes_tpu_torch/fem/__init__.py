"""FEM layer of the port (mirrors krylov_spdes_tpu/fem)."""

from .mesh import (get_mesh, get_delaunay_mesh, get_total_area,  # noqa: F401
                   element_geometry, load_mesh, save_mesh, TriMesh)
from .bc import (get_dirichlet_inds, append_bc, apply_dirichlet,  # noqa: F401
                 DirichletMaps)
from .assembly import (prepare_elliptic_assembly,  # noqa: F401
                       do_isotropic_elliptic_assembly, assemble_values,
                       EllipticAssembly, get_mass_matrix)
from .stencil_assembly import (prepare_stencil_assembly,  # noqa: F401
                               stencil_assemble, make_stencil_operator)
from .partition import (mesh_partition, save_partition,  # noqa: F401
                        load_partition)
from .dd import (DDAssemblyPlan, DDPartition, assemble_dd_values,  # noqa: F401
                 domain_decompose_rhs, get_partition, prepare_dd_assembly,
                 set_subdomains)
from .schur import (SchurOperator, prepare_schur_operator,  # noqa: F401
                    schur_matvec, get_schur_rhs, assemble_local_schurs,
                    assembled_schur_operator, get_subdomain_solutions,
                    merge_subdomain_solutions, do_condensed_assembly,
                    prepare_neumann_neumann_schur_precond)
from .dd_stencil import (DDStencilPlan, assemble_dd_values_stencil,  # noqa: F401
                         condense_dd_stencil, prepare_dd_stencil_assembly)
from .dd_banded import (BandedInteriorTables,  # noqa: F401
                        BandedRefillPlan, SchurOperatorBandedInt,
                        assemble_dd_values_banded, prepare_banded_dd_refill,
                        prepare_banded_interiors,
                        prepare_schur_operator_banded,
                        prepare_schur_operator_banded_refill)
