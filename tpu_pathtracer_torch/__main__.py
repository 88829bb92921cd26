"""``python -m tpu_pathtracer_torch <scene.gltf> <W> <H> <spp> <out.ppm>``."""

from .cli import main

raise SystemExit(main())
