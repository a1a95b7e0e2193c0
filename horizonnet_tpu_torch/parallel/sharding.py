"""Tensor-parallel sharding of the encoder's and height stage's channels.

Counterpart of horizonnet_tpu/parallel/sharding.py, on the port's
state_dict names. The rule (``tp_spec``) is JAX's: under the conv stacks
(``feature_extractor.encoder.*`` and ``reduce_height_module.*``) a conv
weight [cout, cin, kh, kw] shards on cout over 'model', and so do the
per-channel vectors that ride on that cout (a conv bias, the batch
norm's weight, bias, running_mean and running_var); a tensor whose
channel count n_model does not divide replicates, and the bi-LSTM and the
head always replicate. With n_model 1 nothing shards: dp/tp is a layout
change, not a code change.

JAX hands the placements to GSPMD. Here ``shard_state`` makes the
column-parallel unit by hand: each conv and the batch norm that follows
it keep this rank's slice of the output channels; a hook before the conv
sums its input's gradient over the model group, and a hook after the
batch norm gathers all channels over it (ops/collectives.py). cin stays
whole, as in JAX: each layer's output is gathered, no partial sums are
reduced in the forward.
DTensor is not used: its convolution rule takes the output's placement
from the input alone and ignores a weight sharded on cout.

The unit needs every sharded conv to be followed by its batch norm and
to have one group: the resnet encoders and the height stage. The
densenets' pre-activation layers (batch norm before the conv) and
resnext's grouped convs are refused under n_model > 1.
"""

import torch
import torch.distributed as dist
import torch.nn as nn

from ..models.layers import BatchNorm2d, WrapConv
from ..ops.collectives import gather_channels, sum_input_grads

TP_PREFIXES = ("feature_extractor.encoder.", "reduce_height_module.")
_CHANNEL_VECTORS = ("weight", "bias", "running_mean", "running_var")


def tp_spec(name, shape, n_model):
    """The dim a state_dict entry shards on over 'model' (0, its output
    channels), or None where it replicates."""
    if n_model <= 1 or not name.startswith(TP_PREFIXES) or not shape:
        return None
    leaf = name.rsplit(".", 1)[-1]
    if len(shape) == 4 and leaf == "weight" or \
            len(shape) == 1 and leaf in _CHANNEL_VECTORS:
        return 0 if shape[0] % n_model == 0 else None
    return None


def _conv_bn_units(model):
    """(prefix of the conv's parameters, the conv module (a WrapConv or a
    Conv2d), its Conv2d, prefix of the batch norm, batch norm) for each
    conv directly followed by a batch norm among its parent's children,
    and the names of the other convs and batch norms."""
    units, alone = [], []
    for parent_name, parent in model.named_modules():
        if isinstance(parent, WrapConv):
            continue
        kids = list(parent.named_children())
        pre = f"{parent_name}." if parent_name else ""
        for i, (name, mod) in enumerate(kids):
            if isinstance(mod, (nn.Conv2d, WrapConv)):
                conv = mod[1] if isinstance(mod, WrapConv) else mod
                conv_name = pre + name + (".1" if isinstance(mod, WrapConv)
                                          else "")
                nxt = kids[i + 1] if i + 1 < len(kids) else None
                if nxt is not None and isinstance(nxt[1], BatchNorm2d):
                    units.append((conv_name, mod, conv, pre + nxt[0],
                                  nxt[1]))
                else:
                    alone.append(conv_name)
    paired = {u[3] for u in units}
    alone += [n for n, m in model.named_modules()
              if isinstance(m, BatchNorm2d) and n not in paired]
    return units, alone


def _slice(t, rank, n):
    c = t.shape[0] // n
    return t[rank * c:(rank + 1) * c].clone()


@torch.no_grad()
def shard_state(mesh, state):
    """Shard ``state`` (train/step.py::TrainState) over the mesh's model
    axis in place: each conv + batch norm unit that ``tp_spec`` shards
    keeps this rank's slice of its output channels (parameters, running
    statistics and the optimizer's moments alike) and gathers its output
    over the model group, the gradient of its input summed over it.
    Returns the set of sharded state_dict names,
    which ``gather_state`` takes. Call it on the whole model, before
    DistributedDataParallel wraps it."""
    n, r = mesh.n_model, mesh.model_rank
    if n == 1:
        return frozenset()
    model, opt = state.model, state.opt
    units, alone = _conv_bn_units(model)
    for name in alone:
        if name.startswith(TP_PREFIXES):
            raise ValueError(
                f"tensor parallelism shards each conv with the batch norm "
                f"that follows it; {name} has none (the densenet "
                f"encoders' pre-activation layers)")
    old_params = {id(p): k for k, p in model.named_parameters()}
    sharded = set()
    for conv_name, outer, conv, bn_name, bn in units:
        if tp_spec(conv_name + ".weight", tuple(conv.weight.shape),
                   n) is None:
            continue
        if conv.groups != 1:
            raise ValueError(f"tensor parallelism shards ungrouped convs; "
                             f"{conv_name} has {conv.groups} groups")
        for mod, prefix, leaves in ((conv, conv_name, ("weight", "bias")),
                                    (bn, bn_name, _CHANNEL_VECTORS)):
            for leaf in leaves:
                t = getattr(mod, leaf)
                if t is None:
                    continue
                local = _slice(t, r, n)
                if isinstance(t, nn.Parameter):
                    local = nn.Parameter(local, requires_grad=t.requires_grad)
                    name = old_params[id(t)]
                    if name in opt.params:
                        opt.params[name] = local
                        for m in opt.moments.values():
                            m[name] = _slice(m[name], r, n)
                setattr(mod, leaf, local)
                sharded.add(f"{prefix}.{leaf}")
        conv.out_channels //= n
        bn.num_features //= n
        outer.register_forward_pre_hook(_sum_input_grads(mesh.model_group))
        bn.register_forward_hook(_gather_channels(mesh.model_group))
    return frozenset(sharded)


def _sum_input_grads(group):
    return lambda module, args: (sum_input_grads(args[0], group),)


def _gather_channels(group):
    return lambda module, args, out: gather_channels(out, group)


def gather_state(mesh, tensors, sharded):
    """{name: tensor} of this rank's shards -> the whole tensors: each
    name in ``sharded`` gathered over the model group (every model rank
    takes part and gets the result), the others as they are. The tensors
    lie on the rank's device (NCCL gathers CUDA tensors only)."""
    out = {}
    for k, t in tensors.items():
        if k in sharded:
            t = t.contiguous()
            parts = [torch.empty_like(t) for _ in range(mesh.n_model)]
            dist.all_gather(parts, t, group=mesh.model_group)
            t = torch.cat(parts, 0)
        out[k] = t
    return out
