"""Sharded realizes over a mesh of shard slots (the counterpart of the JAX
package's parallel/): `Mesh`, `sharded_realize_rows`, and the engine of the
`distribute()` directive that `Pipeline.realize(..., mesh=...)` calls."""
from .mesh import Mesh  # noqa: F401
from .distribute import sharded_realize_rows  # noqa: F401
