"""Distributed tier (core/distributed analogs): Partition, IndexMap,
row-partitioned Matrix with halo exchange, Schwarz, on a mesh of parts
that share one device (``mesh.py``)."""

from .partition import Partition  # noqa: F401
from .index_map import IndexMap  # noqa: F401
from .mesh import Mesh, make_mesh  # noqa: F401
from .matrix import (DistributedMatrix, distribute_vector,  # noqa: F401
                     read_distributed)
from .matrix2d import (DistributedMatrix2D, read_distributed_2d,  # noqa: F401
                       distribute_vector_2d)
from .schwarz import Schwarz  # noqa: F401
from .vector import Vector  # noqa: F401
from .assembly import assemble_distributed  # noqa: F401
