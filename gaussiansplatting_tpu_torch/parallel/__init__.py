"""Tile-strip sharding over ``torch.distributed`` (counterpart of
gaussiansplatting_tpu/parallel/): ``launch`` starts or joins the process
group, ``mesh`` names the group a sharded step runs over, and ``sharded``
holds the strip render and the sharded train steps."""
