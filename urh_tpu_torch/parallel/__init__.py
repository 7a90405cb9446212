"""Block-sharded DSP over a mesh of shards (:mod:`.sharded`) and its
multi-process form on ``torch.distributed`` (:mod:`.distributed`)."""
