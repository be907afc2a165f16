"""The layers' spatial operations on sharded tensors, under the contexts of
spatial.py (H split over `spatial`) and sharding.py (channels split over
`model`).

`intercepting()` puts a TorchFunctionMode around the model's forward, so the
model code stays as it is (nn.Conv2d, nn.ConvTranspose2d, nn.BatchNorm2d and
F.max_pool2d call into this module through torch's function dispatch):

- conv2d: with its input's channels split, the channels are gathered
  (`GatherChannels`) and only this process's output channels computed, from
  a slice of the weight and bias; with H split, the input gains the rows the
  kernel reads beyond the shard (`Halo`: `padding` rows above, `kernel -
  stride - padding` below), and the conv runs with no padding along H;
- conv_transpose2d: with its input's channels split, the local channels'
  partial products are added over the group (`SumToReplicated`) before the
  bias; with H split, the input gains the rows that reach the shard's
  output rows, and the result is cropped to them;
- max_pool2d: the halo of a conv, filled with -inf at the image's edges;
- avg_pool2d with stride 1 and no padding along H (a VALID window, SSIM's):
  the `kernel - 1` rows below the shard, none below the image; the last
  shard keeps the rows the unsharded output has, `kernel - 1` fewer;
- batch_norm: on a channel split, the local slice of its parameters and
  running statistics (updated in place); train mode on an H shard is the
  data-parallel step's synchronized BN, so it is refused here;
- interpolate, a pad of H, the adaptive pools and other average pools:
  refused on an H shard (their rows mix across shards in ways not ported).

A strided conv, transposed conv or max-pool on an H shard must give the
unsharded layer's rows laid end to end, the shard's rows over the stride
on every process; a layer whose output rows do not split so (AlexNet's
11x11/4 conv gives 63 rows of 256, two shards 32 + 32) raises, naming its
kernel, stride and padding: gather H around such a net (spatial.gather_h).

Every other function passes through. Kernel wrappers run their own plain
operations under `local_ops()`, which sees no sharding.
"""
from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from adam_dehaze_tpu_torch.parallel import sharding, spatial
from adam_dehaze_tpu_torch.parallel.collectives import (
    GatherChannels,
    SumToReplicated,
    channel_slice,
)

_ON: contextvars.ContextVar[bool] = contextvars.ContextVar("intercepting", default=False)


def local_ops():
    """A context in which torch functions run as they are, unsharded: the
    plain operations of a kernel wrapper on a shard it prepared itself."""
    return torch._C.DisableTorchFunction()


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _shard_height(x: torch.Tensor, what: str, kernel: int, stride: int, padding: int,
                  out_rows: int) -> int:
    """The shard's rows, after checking that the unsharded layer, whose
    output has `out_rows` rows for an image of H rows, gives each shard
    h // stride of them."""
    h = x.shape[2]
    if h % stride:
        raise ValueError(f"an H shard of {h} rows does not divide by the stride {stride}: "
                         "H must be divisible by the spatial axis size times every stride "
                         "on the path (pad the image)")
    size = spatial.axis().size
    if out_rows != h // stride * size:
        raise ValueError(
            f"a {what} of kernel {kernel}, stride {stride} and padding {padding} gives "
            f"{out_rows} rows of an image of {h * size}, not the {size} x {h // stride} of "
            f"its H shards: it does not split over the spatial axis (run the net on the "
            f"whole image, spatial.gather_h)")
    return h


def _conv2d(input, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
    channels = sharding.channel_axis(input, weight.shape[1] * groups)
    if channels is not None:
        if groups != 1:
            raise NotImplementedError("a grouped convolution on split channels")
        input = GatherChannels.apply(input, channels)
        part = channel_slice(weight.shape[0], channels)
        sharding.used(weight, bias)
        weight = weight[part]
        bias = None if bias is None else bias[part]
    rows = spatial.axis()
    if rows is None:
        return F.conv2d(input, weight, bias, stride, padding, dilation, groups)
    stride, padding, dilation = _pair(stride), padding, _pair(dilation)
    if isinstance(padding, str) or dilation[0] != 1:
        raise NotImplementedError(f"a convolution with padding {padding!r} and dilation "
                                  f"{dilation} on an H shard")
    (kh, _), (sh, _), (ph, pw) = weight.shape[2:], stride, _pair(padding)
    total = input.shape[2] * rows.size
    h = _shard_height(input, "convolution", kh, sh, ph, (total + 2 * ph - kh) // sh + 1)
    y = F.conv2d(spatial.halo(input, 2, ph, max(kh - sh - ph, 0)), weight, bias, stride,
                 (0, pw), dilation, groups)
    return y if y.shape[2] == h // sh else y[:, :, :h // sh]


def _conv_transpose2d(input, weight, bias=None, stride=1, padding=0, output_padding=0,
                      groups=1, dilation=1):
    channels = sharding.channel_axis(input, weight.shape[0])
    whole_bias, dtype = None, input.dtype
    if channels is not None:
        if groups != 1:
            raise NotImplementedError("a grouped transposed convolution on split channels")
        sharding.used(weight)
        # The partial products in float32 at least: the whole conv rounds its
        # float32 sums once, and so does the sum of the parts.
        wide = torch.promote_types(dtype, torch.float32)
        input = input.to(wide)
        weight = weight[channel_slice(weight.shape[0], channels)].to(wide)
        whole_bias, bias = bias, None
    rows = spatial.axis()
    if rows is None:
        y = F.conv_transpose2d(input, weight, bias, stride, padding, output_padding, groups,
                               dilation)
    else:
        (sh, sw), (ph, pw) = _pair(stride), _pair(padding)
        if _pair(output_padding)[0] or _pair(dilation)[0] != 1:
            raise NotImplementedError("a transposed convolution with an output padding or "
                                      "a dilation on an H shard")
        kh, h = weight.shape[2], input.shape[2]
        out_rows = (h * rows.size - 1) * sh - 2 * ph + kh
        if out_rows != sh * h * rows.size:
            raise ValueError(
                f"a transposed convolution of kernel {kh}, stride {sh} and padding {ph} gives "
                f"{out_rows} rows of an image of {h * rows.size}, not the {rows.size} x "
                f"{sh * h} of its H shards: it does not split over the spatial axis")
        # Output row o reads input rows (o + p - k + 1) / s ... (o + p) / s.
        top, bottom = max((kh - 1 - ph) // sh, 0), max((ph + sh - 1) // sh, 0)
        y = F.conv_transpose2d(spatial.halo(input, 2, top, bottom), weight, bias, (sh, sw),
                               (0, pw), (0, _pair(output_padding)[1]), groups, dilation)
        y = y[:, :, sh * top + ph:sh * top + ph + sh * h]
    if channels is not None:
        y = SumToReplicated.apply(y, channels)
        if whole_bias is not None:
            y = y + whole_bias.to(y.dtype).view(1, -1, 1, 1)
        y = y.to(dtype)
        sharding.close_region()
    return y


def _max_pool2d(input, kernel_size, stride=None, padding=0, dilation=1, ceil_mode=False,
                return_indices=False):
    rows = spatial.axis()
    if rows is None:
        return F.max_pool2d(input, kernel_size, stride, padding, dilation, ceil_mode,
                            return_indices)
    k = _pair(kernel_size)
    s = _pair(stride) if stride else k
    p = _pair(padding)
    if ceil_mode or return_indices or _pair(dilation)[0] != 1:
        raise NotImplementedError("a max-pool with ceil_mode, indices or a dilation on an "
                                  "H shard")
    total = input.shape[2] * rows.size
    h = _shard_height(input, "max-pool", k[0], s[0], p[0], (total + 2 * p[0] - k[0]) // s[0] + 1)
    y = F.max_pool2d(spatial.halo(input, 2, p[0], max(k[0] - s[0] - p[0], 0), -math.inf),
                     k, s, (0, p[1]))
    return y if y.shape[2] == h // s[0] else y[:, :, :h // s[0]]


def _avg_pool2d(input, kernel_size, stride=None, padding=0, ceil_mode=False,
                count_include_pad=True, divisor_override=None):
    rows = spatial.axis()
    if rows is None:
        return F.avg_pool2d(input, kernel_size, stride, padding, ceil_mode, count_include_pad,
                            divisor_override)
    k = _pair(kernel_size)
    s = _pair(stride) if stride else k
    p = _pair(padding)
    if s[0] != 1 or p[0] != 0 or ceil_mode:
        raise NotImplementedError(f"an average pool of stride {s[0]} and padding {p[0]} along "
                                  "H on an H shard: only a VALID window (stride 1, no "
                                  "padding) is ported")
    return F.avg_pool2d(spatial.halo(input, 2, 0, k[0] - 1, fill=None), k, (1, s[1]),
                        (0, p[1]), ceil_mode, count_include_pad, divisor_override)


def _batch_norm(input, running_mean, running_var, weight=None, bias=None, training=False,
                momentum=0.1, eps=1e-5):
    n = (running_mean if running_mean is not None else weight).shape[0]
    channels = sharding.channel_axis(input, n)
    if channels is not None:
        part = channel_slice(n, channels)
        sharding.used(weight, bias)
        running_mean, running_var, weight, bias = (
            None if t is None else t[part] for t in (running_mean, running_var, weight, bias))
    if training and spatial.axis() is not None:
        raise NotImplementedError(
            "train-mode BatchNorm on an H shard: take the step through "
            "parallel/data_parallel.py:shard_train_step, which synchronizes its statistics")
    return F.batch_norm(input, running_mean, running_var, weight, bias, training, momentum,
                        eps)


def _refused(name):
    def rule(*args, **kwargs):
        raise NotImplementedError(f"{name} on an H shard is not ported (its rows mix across "
                                  "the shards)")
    return rule


def _pad(input, pad, mode="constant", value=None):
    if input.dim() == 4 and len(pad) >= 4 and any(pad[2:4]) and spatial.axis() is not None:
        raise NotImplementedError("a pad of H on an H shard is not ported")
    return F.pad(input, pad, mode, value)


_RULES = {F.conv2d: _conv2d, F.conv_transpose2d: _conv_transpose2d,
          F.max_pool2d: _max_pool2d, F.avg_pool2d: _avg_pool2d, F.batch_norm: _batch_norm,
          F.pad: _pad}
_SPATIAL_REFUSED = {f: _refused(f.__name__) for f in (
    F.interpolate, F.adaptive_avg_pool2d, F.adaptive_max_pool2d)}


class ShardedOps(TorchFunctionMode):
    """Routes the functions in `_RULES` (and, on an H shard, the refused
    ones) to their sharded versions; everything else passes through."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        rule = _RULES.get(func)
        if rule is None and spatial.axis() is not None:
            rule = _SPATIAL_REFUSED.get(func)
        return (rule or func)(*args, **kwargs)


@contextlib.contextmanager
def intercepting():
    """ShardedOps around the context (once, however deeply the sharding
    contexts nest)."""
    if _ON.get():
        yield
        return
    token = _ON.set(True)
    try:
        with ShardedOps():
            yield
    finally:
        _ON.reset(token)
