from orc_tpu_torch.mesh.zones import BoundaryTable, CellZone, FaceCondition, FaceZone  # noqa: F401
from orc_tpu_torch.mesh.compile import (  # noqa: F401
    CompiledMesh,
    compile_from_arrays,
    compile_mesh,
    to_raw_order,
    trim_for_ck,
)
from orc_tpu_torch.mesh.generate import structured_box_mesh, write_tgrid  # noqa: F401
from orc_tpu_torch.mesh.reorder import SlicePlan  # noqa: F401
from orc_tpu_torch.mesh.tgrid import read_mesh  # noqa: F401
