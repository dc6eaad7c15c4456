"""Multi-GPU runs of the port on torch.distributed: the process group,
the (dp, fsdp, sp) mesh, the sharding context, Ulysses and ring
sequence parallelism, FSDP2 parameter sharding, and a local launcher.
The names follow `video_styler_tpu.parallel`, but for `constrain`: GSPMD's
sharding constraint has no eager counterpart (`split_seq`/`gather_seq`
move the rows, `split_w`/`gather_w`/`halo_exchange_w` the VAE's columns)."""
from .mesh import local_device_count, make_global_mesh, make_mesh, parse_mesh
from .context import (ShardingContext, use_sharding, current_sharding, split_seq, gather_seq,
                      split_w, gather_w, halo_exchange_w, drop_count, reset_drop_count)
from .fsdp import shard_params_fsdp, replicate_params, gathered
from .ulysses import ulysses_attention
from .ring import ring_attention
from .distributed import (
    initialize, initialize as initialize_distributed, is_distributed, is_main_process,
    process_index, process_count, sync_processes, broadcast_object)
from .launch import run_local
