from .mesh import (MeshContext, current_mesh, use_mesh, initialize_distributed,
                   ROW_AXIS)

__all__ = ["MeshContext", "current_mesh", "use_mesh",
           "initialize_distributed", "ROW_AXIS"]
