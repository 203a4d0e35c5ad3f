"""Dataset plane of the port: webdataset tar shards as a streaming input
landed on the card (the port's copy of ``dragonfly2_tpu/dataset/``).

  tar_index     one-pass tar header walk -> compact per-shard sample
                index, cached pod-wide as an object beside the shard
  shard_reader  sample byte spans -> ranged P2P tasks (embedded daemon or
                object-gateway transport), pooled span buffers
  loader        deterministic pod-sharded epoch iterator with bounded
                readahead (exactly-once per epoch across hosts)
  device_feed   fixed-size record batches landed through the port's sink,
                one K2 launch a batch, verified on the card
"""

from dragonfly2_tpu_torch.dataset.device_feed import (   # noqa: F401
    DeviceBatch,
    DeviceFeed,
    DeviceFeedError,
)
from dragonfly2_tpu_torch.dataset.loader import (   # noqa: F401
    LoaderError,
    LoaderOptions,
    PodShardedLoader,
    epoch_order,
    host_partition,
    interleave_shards,
    plan_host_epoch,
)
from dragonfly2_tpu_torch.dataset.shard_reader import (   # noqa: F401
    DaemonRangeFetcher,
    GatewayRangeFetcher,
    ShardReadError,
    ShardReader,
)
from dragonfly2_tpu_torch.dataset.tar_index import (   # noqa: F401
    Sample,
    ShardIndex,
    TarIndexer,
    TarIndexError,
    TarMember,
    TruncatedShardError,
    fetch_or_build_index,
    index_tar_bytes,
)
