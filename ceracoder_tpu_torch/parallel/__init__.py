"""Multi-device encode schedules (port of ceracoder_tpu/parallel/).

- ``mesh``: a (streams, rows) grid of torch devices and the row-banded
  H.264 intra step (``encode_sharded``);
- ``hevc``: the banded HEVC step with halo exchange, the app's
  ``ShardedH265Encoder`` and ``GopParallelStreamEncoder``;
- ``gop``: ``GopParallelEncoder.encode_clip``, a clip in closed GOPs
  over ``GopParallelStreamEncoder``'s devices.

Everything runs in one process over a list of devices; a device listed
more than once runs its shards one after another.
"""
