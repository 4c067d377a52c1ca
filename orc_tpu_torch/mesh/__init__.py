from orc_tpu_torch.mesh.zones import BoundaryTable, CellZone, FaceCondition, FaceZone  # noqa: F401
from orc_tpu_torch.mesh.compile import CompiledMesh, trim_for_ck  # noqa: F401
from orc_tpu_torch.mesh.generate import structured_box_mesh  # noqa: F401
