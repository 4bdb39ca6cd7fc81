"""Tiny sizes of each cell for the CPU tests (the cells' shapes, scaled down)."""

RENDER = {"config": {"output_size": [24, 14], "volume": {"n": 24}, "camera": {"position": [48.0, 0.0, 0.0]}},
          "mix": {"check": {"within_waves": 3, "waves": 2, "pixels": 96}}}
FIRE = {"config": {"output_size": [24, 14], "volume": {"height": 16, "radius": 5.0, "voxel_size": 1.0},
                   "camera": {"position": [22.0, 8.0, 0.0], "look": [0.0, 8.0, 0.0]}},
        "mix": {"check": {"within_waves": 3, "waves": 2, "pixels": 96}}}
TRAIN = {"mix": {"volume_n": 16, "pixels": [8, 8], "ring_radius": 40.0, "n_iters": 256, "views": 3,
                 "restore_every": 2}}

CELLS = {"wdas_cloud.render": RENDER, "fire.render": FIRE, "wdas_cloud.render.4gpu": RENDER, "wdas_cloud.train": TRAIN}
SEED = 2 ** 31 + 977
