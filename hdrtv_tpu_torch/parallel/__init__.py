"""Device meshes (``mesh.py``), the halo exchange of the spatially sharded
frame programs (``halo.py``) and the multi-host export farm's plan
(``multihost.py``)."""

from hdrtv_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    frame_sharding,
    make_mesh,
    replicate_params,
    spatial_mesh,
)
