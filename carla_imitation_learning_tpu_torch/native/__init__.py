"""The packed frame store (this package's copy of ``framestore.cpp``,
built with g++ and bound with ctypes) and its sharded form: mmap loads, a
threaded window-batch prefetcher that keeps batch order, and card
streaming of whole shards."""

from carla_imitation_learning_tpu_torch.native.framestore import (  # noqa: F401
    NativeFrameStore,
    PrefetchReader,
    build_library,
    save_framestore,
)
from carla_imitation_learning_tpu_torch.native.sharded import (  # noqa: F401
    DeviceShardStreamer,
    ShardedFrameStore,
    ShardedPrefetchReader,
    save_sharded_framestore,
)
