"""Scale-out over ``torch.distributed``: the (data, tile) mesh
(:mod:`.mesh`), process-group set-up (:mod:`.distributed`), the row halo
exchange (:mod:`.halo`) and row tiling of a forward (:mod:`.tiling`)."""

from . import collectives, distributed, halo, mesh, tiling

__all__ = ["collectives", "distributed", "halo", "mesh", "tiling"]
