"""Small sizes at which the benchmark's cells run on the CPU in the tests."""

SYNTH = {"config": {"scene": {"gaussians": 400, "spread": 0.6, "width": 64, "height": 48},
                    "config": {"raster": {"pair_capacity": 1 << 15, "pair_block": 16}}},
         "traffic": {"orbit": {"azimuths": 2, "elevations": 2}, "sample_frames": 3}}

# the control's readings grow with the frame: a size at which they pass the
# cells' limits as they do at full size
SYNTH_CONTROL = {"config": {"scene": {"gaussians": 4000, "spread": 1.0, "width": 160,
                                      "height": 120},
                            "config": {"raster": {"pair_capacity": 1 << 17,
                                                  "pair_block": 32}}},
                 "traffic": {"orbit": {"azimuths": 2, "elevations": 2}, "sample_frames": 2}}

GARDEN = {"config": {"scene": {"views": 20, "width": 96, "height": 64, "points": 3000},
                     "epochs": 1,
                     "loop": {"min_pair_capacity": 1 << 17},
                     "config": {"raster": {"pair_capacity": 1 << 17, "pair_block": 16},
                                "init": {"knn_sample_threshold": 500},
                                "density": {"densify_from_iter": 5, "densify_interval": 5}}},
          "traffic": {"check_events": [10, 15], "check_late": 16}}

GARDEN_RENDER = {"config": {"scene": {"views": 20, "width": 48, "height": 32},
                            "render": {"gaussians": 3000, "ring_views": 3,
                                       "pair_capacity": 1 << 16},
                            "config": {"raster": {"pair_block": 16},
                                       "init": {"knn_sample_threshold": 500}}},
                 "traffic": {"sample_frames": 2}}
