"""The in-tree transformer workload on PyTorch: the model and its train
steps (one device, the mesh, sequence, expert and pipeline parallelism),
cached attention and generation, the continuous-batching engine, the
checkpoint contract, and the CLIs (``serve``, ``generate``, ``train``,
``tokenizer``).

The public names are the JAX package's ``workloads.__all__``, each from
its port module.  Importing them builds no kernel and no loader and
does not initialise CUDA: every build happens at a kernel's or the
loader's first use.  As in the JAX package, ``generate`` is
``decode.generate`` until the ``generate`` CLI module is imported, which
Python then binds over the name; import the CLI module by its full name.
"""

from tpu_autoscaler_torch.workloads.model import (
    ModelConfig,
    TrainConfig,
    forward,
    init_params,
    loss_fn,
    make_optimizer,
    make_sharded_train_step,
    make_mesh,
)
from tpu_autoscaler_torch.workloads.decode import (
    KVCache,
    decode_step,
    extend_step,
    generate,
    make_sharded_generate,
    prefill,
    speculative_generate,
)
from tpu_autoscaler_torch.workloads.pipeline import (
    make_pipeline3d_train_step,
    make_pipeline_mesh,
    make_pipeline_train_step,
    merge_qkv_weights,
    split_qkv_weights,
)
from tpu_autoscaler_torch.workloads.sp import make_sp_mesh, make_sp_train_step
from tpu_autoscaler_torch.workloads.moe import (
    make_ep_mesh,
    make_ep_train_step,
)
from tpu_autoscaler_torch.workloads.serving import (
    ContinuousBatcher,
    Request,
    SlotKVCache,
)
from tpu_autoscaler_torch.workloads.checkpoint import (
    DrainWatcher,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = [
    "ContinuousBatcher",
    "DrainWatcher",
    "KVCache",
    "ModelConfig",
    "Request",
    "SlotKVCache",
    "TrainConfig",
    "decode_step",
    "extend_step",
    "forward",
    "generate",
    "init_params",
    "loss_fn",
    "make_ep_mesh",
    "make_ep_train_step",
    "make_mesh",
    "make_optimizer",
    "make_pipeline3d_train_step",
    "make_pipeline_mesh",
    "make_pipeline_train_step",
    "make_sharded_generate",
    "make_sp_mesh",
    "make_sp_train_step",
    "make_sharded_train_step",
    "merge_qkv_weights",
    "prefill",
    "restore_checkpoint",
    "save_checkpoint",
    "speculative_generate",
    "split_qkv_weights",
]
