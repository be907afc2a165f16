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
- interpolate (bilinear, with or without antialias, with half-pixel
  centres or align-corners, and nearest-exact): a `size` gives the shard's
  output rows (the models read their sizes off their shards) and a
  `scale_factor` scales the whole image's. Where the output has as many
  rows as the input and the op is the identity along H, the shard resizes
  W alone. Otherwise the H pass is the unsharded op's own (H_out x H_in)
  matrix, read off F.interpolate of an identity image with the same
  arguments (so its weights are torch's, whatever the formula), cut to
  this shard's output rows and the band of source rows they read; the band
  comes through `spatial.halo` (gathered when it is taller than a shard),
  is contracted over H in float32 at least, and W is resized after it by
  F.interpolate, the identity along H. Other modes, and outputs whose rows
  do not split evenly over the shards, raise;
- adaptive average and max pools: to 1 x 1 the whole image's mean or max
  (`spatial.mean_hw`, `image_amax`); to the whole image's H, along W on the
  shard; other sizes raise;
- a pad of H and average pools other than a VALID stride-1 window: refused
  on an H shard. No model forward of the package pads H or takes a strided
  average pool (the one pad of H, the integral image of
  data/synthetic.py:_box_filter, runs on a taller shard under
  `local_ops()`), so these have no rule.

A strided conv, transposed conv or max-pool on an H shard must give the
unsharded layer's rows laid end to end, the shard's rows over the stride
on every process; a layer whose output rows do not split so (AlexNet's
11x11/4 conv gives 63 rows of 256, two shards 32 + 32) raises, naming its
kernel, stride and padding: gather H around such a net (spatial.gather_h).

Every other function passes through. Kernel wrappers run their own plain
operations under `local_ops()`, which sees no sharding.

`captured()` takes the sharding state open where it is called (the
contexts' variables and this interception) and gives it back later, on any
thread: a checkpointed forward recomputes in the backward (training/
remat.py), which the card's autograd engine runs on a thread of its own.
That thread inherits torch's function modes from the forward's thread but
not its context variables, so the interception is entered there only where
the thread lacks it.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from adam_dehaze_tpu_torch.parallel import sharding, spatial
from adam_dehaze_tpu_torch.parallel.collectives import (
    GatherChannels,
    SumToReplicated,
    _memory_format,
    channel_slice,
)


def local_ops():
    """A context in which torch functions run as they are, unsharded: the
    plain operations of a kernel wrapper on a shard it prepared itself."""
    return torch._C.DisableTorchFunction()


def _pair(v):
    return (v, v) if isinstance(v, (int, float)) else tuple(v)


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


# The modes of F.interpolate that run on an H shard: those the package's
# models and the half-resolution dial use (nn/blocks.py, models/detection.py).
RESIZE_MODES = ("bilinear", "nearest-exact")
# (rows in, H arguments, mode, align_corners, antialias, dtype, device, shards)
# -> (the op's matrix along H, whether it is the identity, the halo a shard
# takes above and below, each shard's band of source rows).
_RESIZE_PLANS = {}


def _resize_plan(rows_in, h_args, mode, align_corners, antialias, dtype, device, shards):
    """F.interpolate's weights along H for an image of `rows_in` rows: the
    op applied to an identity image (column j one-hot at row j) whose W it
    leaves as it is; row o of the result holds output row o's weights over
    the source rows. With the halo every shard takes so that each shard's
    output rows find the source rows they read, and those bands."""
    key = (rows_in, tuple(sorted(h_args.items())), mode, align_corners, antialias, dtype,
           device, shards)
    plan = _RESIZE_PLANS.get(key)
    if plan is not None:
        return plan
    with torch.inference_mode(False), torch.no_grad():
        eye = torch.eye(rows_in, dtype=dtype, device=device)
        m = F.interpolate(eye[None, None], mode=mode, align_corners=align_corners,
                          antialias=antialias, **h_args)[0, 0].contiguous()
        identity = m.shape == eye.shape and torch.equal(m, eye)
    rows_out = m.shape[0]
    if rows_out % shards:
        raise ValueError(f"an interpolate to {rows_out} rows of an image of {rows_in} does not "
                         f"split into {shards} equal H shards")
    n_in, n_out = rows_in // shards, rows_out // shards
    bands, top, bottom = [], 0, 0
    reads = (m != 0).cpu()
    for r in range(shards):
        cols = reads[r * n_out:(r + 1) * n_out].any(0).nonzero()
        lo, hi = int(cols.min()), int(cols.max()) + 1
        bands.append((lo, hi))
        top, bottom = max(top, r * n_in - lo), max(bottom, hi - (r + 1) * n_in)
    plan = _RESIZE_PLANS[key] = (m, identity, top, bottom, bands)
    return plan


def _interpolate(input, size=None, scale_factor=None, mode="nearest", align_corners=None,
                 recompute_scale_factor=None, antialias=False):
    rows = spatial.axis()
    if rows is None:
        return F.interpolate(input, size, scale_factor, mode, align_corners,
                             recompute_scale_factor, antialias)
    if input.dim() != 4 or mode not in RESIZE_MODES:
        raise NotImplementedError(f"an interpolate of mode {mode!r} on a {input.dim()}-d H "
                                  f"shard: only 4-d {' and '.join(RESIZE_MODES)} are ported")
    h, total = input.shape[2], input.shape[2] * rows.size
    same = dict(mode=mode, align_corners=align_corners, antialias=antialias)
    if size is not None:
        out_h, out_w = _pair(size)
        h_args = {"size": (out_h * rows.size, total)}

        def w_args(local):
            return {"size": (local, out_w)}
    else:
        sh, sw = _pair(scale_factor)
        if math.floor(float(total) * sh) % rows.size:
            raise ValueError(
                f"an interpolate by {sh} along H gives {math.floor(float(total) * sh)} rows of "
                f"an image of {total}: they do not split into {rows.size} equal H shards")
        h_args = {"scale_factor": (sh, 1.0), "recompute_scale_factor": recompute_scale_factor}

        def w_args(local):
            return {"scale_factor": (1.0, sw), "recompute_scale_factor": recompute_scale_factor}
    wide = torch.promote_types(input.dtype, torch.float32)
    m, identity, top, bottom, bands = _resize_plan(total, h_args, mode, align_corners,
                                                   antialias, wide, input.device, rows.size)
    if identity:
        return F.interpolate(input, **w_args(h), **same)
    out_h = m.shape[0] // rows.size
    lo, hi = bands[rows.index]
    src = spatial.halo(input, 2, top, bottom, fill=None)
    band = src.narrow(2, lo - max(rows.index * h - top, 0), hi - lo).to(wide)
    part = m[rows.index * out_h:(rows.index + 1) * out_h, lo:hi]
    y = torch.matmul(part, band)
    y = F.interpolate(y, **w_args(out_h), **same)
    return y.to(input.dtype).contiguous(memory_format=_memory_format(input))


def _adaptive_rows(input, output_size, what):
    """The adaptive pool's output (rows, columns) with None read as the
    whole image's size, after checking it is 1 x 1 or the whole image's
    H."""
    total, w = spatial.rows_total(input.shape[2]), input.shape[3]
    oh, ow = _pair(output_size)
    oh, ow = total if oh is None else oh, w if ow is None else ow
    if (oh, ow) != (1, 1) and oh != total:
        raise NotImplementedError(
            f"an adaptive {what} pool to {oh} x {ow} of an image of {total} rows on an H "
            "shard: only 1 x 1 and the whole image's H are ported")
    return oh, ow


def _adaptive_avg_pool2d(input, output_size):
    if spatial.axis() is None:
        return F.adaptive_avg_pool2d(input, output_size)
    oh, ow = _adaptive_rows(input, output_size, "average")
    if (oh, ow) == (1, 1):
        return spatial.mean_hw(input, keepdim=True)
    return F.adaptive_avg_pool2d(input, (input.shape[2], ow))


def _adaptive_max_pool2d(input, output_size, return_indices=False):
    if spatial.axis() is None:
        return F.adaptive_max_pool2d(input, output_size, return_indices)
    if return_indices:
        raise NotImplementedError("an adaptive max pool with indices on an H shard")
    oh, ow = _adaptive_rows(input, output_size, "max")
    if (oh, ow) == (1, 1):
        return spatial.image_amax(input, (2, 3), keepdim=True)
    return F.adaptive_max_pool2d(input, (input.shape[2], ow))


def _pad(input, pad, mode="constant", value=None):
    if input.dim() == 4 and len(pad) >= 4 and any(pad[2:4]) and spatial.axis() is not None:
        raise NotImplementedError("a pad of H on an H shard is not ported")
    return F.pad(input, pad, mode, value)


_RULES = {F.conv2d: _conv2d, F.conv_transpose2d: _conv_transpose2d,
          F.max_pool2d: _max_pool2d, F.avg_pool2d: _avg_pool2d, F.batch_norm: _batch_norm,
          F.pad: _pad, F.interpolate: _interpolate, F.adaptive_avg_pool2d: _adaptive_avg_pool2d,
          F.adaptive_max_pool2d: _adaptive_max_pool2d}


class ShardedOps(TorchFunctionMode):
    """Routes the functions in `_RULES` to their sharded versions;
    everything else passes through."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        return _RULES.get(func, func)(*args, **(kwargs or {}))


def _intercepting_here() -> bool:
    """Whether this thread's torch function modes hold a ShardedOps."""
    return any(isinstance(m, ShardedOps)
               for m in torch.overrides._get_current_function_mode_stack())


@contextlib.contextmanager
def intercepting():
    """ShardedOps around the context (once, however deeply the sharding
    contexts nest)."""
    if _intercepting_here():
        yield
        return
    with ShardedOps():
        yield


def captured():
    """The sharding state open here: spatial.py's rows, sharding.py's
    channel region, the data-parallel step's rows and groups
    (data_parallel.py), and the interception. Returns a function that gives
    a context manager re-entering that state as it is now, on whatever
    thread it is entered."""
    from adam_dehaze_tpu_torch.parallel import data_parallel
    saved = [(var, var.get()) for var in (spatial._ROWS, data_parallel._ROWS,
                                          data_parallel._GROUPS)]
    tp = sharding._ACTIVE.get()
    region = None if tp is None else tp.region
    sharded = tp is not None or spatial.axis() is not None

    @contextlib.contextmanager
    def reenter():
        # A region of its own, as it stood: the forward's may have moved on.
        channels = None if tp is None else sharding._Channels(tp.axis)
        if channels is not None:
            channels.region = region
        tokens = [(var, var.set(value)) for var, value in
                  saved + [(sharding._ACTIVE, channels)]]
        try:
            with intercepting() if sharded else contextlib.nullcontext():
                yield
        finally:
            for var, token in reversed(tokens):
                var.reset(token)

    return reenter
