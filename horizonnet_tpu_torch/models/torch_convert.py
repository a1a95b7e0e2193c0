"""The JAX package's variables <-> the port's (the reference's) state_dict.

``variables_to_state_dict`` is the exact inverse of horizonnet_tpu/models/
torch_convert.py::torch_state_to_variables (resnet family): conv HWIO ->
OIHW, with the ``.1`` infix on width-padded (k > 1) convs; dense kernel
[in, out] -> weight [out, in]; BN scale/bias/mean/var -> weight/bias/
running_mean/running_var (num_batches_tracked 0); LSTM ``l{k}_w_ih/w_hh/b``
[D, ...] -> ``weight_ih_l{k}[_reverse]`` etc. with bias_ih = b and
bias_hh = 0. Every leaf of the variables is consumed; an unknown one
raises. ``state_dict_to_variables`` goes back, so the port writes the JAX
package's ``.ckpt`` trees (train/checkpoint.py).
"""

import numpy as np
import torch


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))


class _Writer:
    def __init__(self):
        self.sd = {}

    def conv(self, key, node):
        node = dict(node)
        k = np.asarray(node.pop("kernel"))
        infix = ".1" if k.shape[0] > 1 or k.shape[1] > 1 else ""
        self.sd[f"{key}{infix}.weight"] = _t(k.transpose(3, 2, 0, 1))
        if "bias" in node:
            self.sd[f"{key}{infix}.bias"] = _t(node.pop("bias"))
        if node:
            raise KeyError(f"{key}: unused conv leaves {sorted(node)}")

    def bn(self, key, p, s):
        if set(p) != {"scale", "bias"} or set(s) != {"mean", "var"}:
            raise KeyError(f"{key}: BN leaves {sorted(p)} / {sorted(s)}")
        self.sd[f"{key}.weight"] = _t(p["scale"])
        self.sd[f"{key}.bias"] = _t(p["bias"])
        self.sd[f"{key}.running_mean"] = _t(s["mean"])
        self.sd[f"{key}.running_var"] = _t(s["var"])
        self.sd[f"{key}.num_batches_tracked"] = torch.tensor(0)

    def dense(self, key, node):
        if set(node) != {"kernel", "bias"}:
            raise KeyError(f"{key}: dense leaves {sorted(node)}")
        self.sd[f"{key}.weight"] = _t(np.asarray(node["kernel"]).T)
        self.sd[f"{key}.bias"] = _t(node["bias"])


def _encoder(w, params, stats):
    pre = "feature_extractor.encoder"
    for name, p in params.items():
        s = stats.get(name, {})
        if name == "conv1":
            w.conv(f"{pre}.conv1", p["conv"])
        elif name == "bn1":
            w.bn(f"{pre}.bn1", p["bn"], s["bn"])
        elif name.startswith("layer"):
            li, bi = name[len("layer"):].split("_")
            t = f"{pre}.layer{li}.{bi}"
            for sub, sp in p.items():
                if sub.startswith("conv"):
                    w.conv(f"{t}.{sub}", sp["conv"])
                elif sub.startswith("bn"):
                    w.bn(f"{t}.{sub}", sp["bn"], s[sub]["bn"])
                elif sub == "downsample_conv":
                    w.conv(f"{t}.downsample.0", sp["conv"])
                elif sub == "downsample_bn":
                    w.bn(f"{t}.downsample.1", sp["bn"], s[sub]["bn"])
                else:
                    raise KeyError(f"encoder/{name}/{sub}")
        else:
            raise NotImplementedError(
                f"encoder/{name}: only the float resnet encoders convert "
                "(densenet and int8 trees are ROADMAP Queue 1 item 7)")


def variables_to_state_dict(variables):
    """{'params', 'batch_stats'} of horizonnet_tpu (numpy or jax arrays)
    -> the reference state_dict of CPU float tensors."""
    params = dict(variables["params"])
    stats = variables.get("batch_stats", {})
    w = _Writer()
    _encoder(w, params.pop("encoder"), stats.get("encoder", {}))
    for gi, g in params.pop("height").items():
        i = int(gi[len("ghc"):])
        for cj, c in g.items():
            j = int(cj[len("c"):])
            t = f"reduce_height_module.ghc_lst.{i}.layer.{j}.layers"
            w.conv(f"{t}.0", c["conv"]["conv"])
            w.bn(f"{t}.1", c["bn"]["bn"], stats["height"][gi][cj]["bn"]["bn"])
    if "bi_rnn" in params:
        rnn = dict(params.pop("bi_rnn"))
        for layer in range(len(rnn) // 3):
            w_ih = np.asarray(rnn.pop(f"l{layer}_w_ih"))
            w_hh = np.asarray(rnn.pop(f"l{layer}_w_hh"))
            b = np.asarray(rnn.pop(f"l{layer}_b"))
            for d, sfx in enumerate(("", "_reverse")[:w_ih.shape[0]]):
                w.sd[f"bi_rnn.weight_ih_l{layer}{sfx}"] = _t(w_ih[d])
                w.sd[f"bi_rnn.weight_hh_l{layer}{sfx}"] = _t(w_hh[d])
                w.sd[f"bi_rnn.bias_ih_l{layer}{sfx}"] = _t(b[d])
                w.sd[f"bi_rnn.bias_hh_l{layer}{sfx}"] = torch.zeros(
                    b.shape[-1], dtype=w.sd[f"bi_rnn.bias_ih_l{layer}{sfx}"]
                    .dtype)
        if rnn:
            raise KeyError(f"bi_rnn: unused leaves {sorted(rnn)}")
        w.dense("linear", params.pop("linear"))
    else:
        w.dense("linear.0", params.pop("linear_0"))
        w.dense("linear.3", params.pop("linear_1"))
    if params:
        raise KeyError(f"unused parameter groups {sorted(params)}")
    return w.sd


def _put(tree, path, leaf):
    for name in path[:-1]:
        tree = tree.setdefault(name, {})
    if path[-1] in tree:
        raise KeyError(f"{'/'.join(path)} written twice")
    tree[path[-1]] = leaf


def _module_path(parts):
    """state_dict key parts (without the leaf name) -> (flax module path,
    "conv" or "bn"); the reverse of _encoder / the height loop above. A
    width-padded conv's ``.1`` infix is a trailing part, ignored."""
    if parts[:2] == ["feature_extractor", "encoder"]:
        p = parts[2:]
        path = ["encoder"]
        if p[0].startswith("layer"):
            path.append(f"{p[0]}_{p[1]}")
            p = p[2:]
            if p[0] == "downsample":
                p = ["downsample_conv" if p[1] == "0" else "downsample_bn"]
        path.append(p[0])
        return path, "bn" if "bn" in p[0] else "conv"
    if parts[:2] == ["reduce_height_module", "ghc_lst"]:
        # reduce_height_module.ghc_lst.{i}.layer.{j}.layers.{0 conv | 1 bn}
        i, j, which = parts[2], parts[4], parts[6]
        kind = "conv" if which == "0" else "bn"
        return ["height", f"ghc{i}", f"c{j}", kind], kind
    raise KeyError(".".join(parts))


def state_dict_to_variables(state_dict):
    """The port's state_dict (tensors on any device) -> {'params',
    'batch_stats'} of horizonnet_tpu as numpy float arrays; the folded
    LSTM bias is bias_ih + bias_hh. Every key is consumed; an unknown one
    raises."""
    params, stats, rnn = {}, {}, {}
    for key, t in state_dict.items():
        parts = key.split(".")
        leaf = parts[-1]
        if leaf == "num_batches_tracked":
            continue
        a = t.detach().float().cpu().numpy()
        if parts[0] == "bi_rnn":
            rnn[leaf] = a
        elif parts[0] == "linear":
            name = {("linear",): "linear", ("linear", "0"): "linear_0",
                    ("linear", "3"): "linear_1"}.get(tuple(parts[:-1]))
            if name is None:
                raise KeyError(key)
            _put(params, [name, "kernel" if leaf == "weight" else "bias"],
                 a.T if leaf == "weight" else a)
        else:
            path, kind = _module_path(parts[:-1])
            if kind == "conv":
                _put(params, path + ["conv", {"weight": "kernel",
                                              "bias": "bias"}[leaf]],
                     a.transpose(2, 3, 1, 0) if leaf == "weight" else a)
            elif leaf in ("weight", "bias"):
                _put(params, path + ["bn", "scale" if leaf == "weight"
                                     else "bias"], a)
            else:
                _put(stats, path + ["bn", {"running_mean": "mean",
                                           "running_var": "var"}[leaf]], a)
    if rnn:
        layers = len([k for k in rnn if k.startswith("weight_ih_l")
                      and not k.endswith("_reverse")])
        for layer in range(layers):
            get = lambda n: np.stack([  # noqa: E731
                rnn.pop(f"{n}_l{layer}{sfx}") for sfx in ("", "_reverse")])
            params.setdefault("bi_rnn", {}).update({
                f"l{layer}_w_ih": get("weight_ih"),
                f"l{layer}_w_hh": get("weight_hh"),
                f"l{layer}_b": get("bias_ih") + get("bias_hh")})
        if rnn:
            raise KeyError(f"bi_rnn: unused keys {sorted(rnn)}")
    return {"params": params, "batch_stats": stats}
