"""Extended transform zoo of the RCN/RDN baselines (numpy).

Copied from `smilecode_tpu/data/trans_ext.py` (the RDN baseline's
`data/trans.py` and the RCN subset), with its draws from Python's `random`
and `np.random` call for call, so that one seed gives both packages the
same result. All transforms follow the `Base.sample/tf` protocol of
`smilecode_tpu_torch.data.trans`; images are (1, D, H, W[, C]) arrays, k=0
for images and k=1 for labels.

Deviations from the reference (documented bugs fixed):
  * `GaussianBlur.tf` referenced an undefined ``self.num``
    (`RDN/data/trans.py:452` latent crash) — here ``app`` maps to ``num``.
  * `Resize_img` used skimage (absent in this image); scipy.ndimage.zoom
    with matching order (0 for labels, 3 for images) replaces it.
"""

from __future__ import annotations

import math
import random

import numpy as np
from scipy import ndimage

from smilecode_tpu_torch.data.rand import Constant, Gaussian, Uniform  # noqa: F401
from smilecode_tpu_torch.data.trans import Base, Compose, NumpyType, Seg_norm  # noqa: F401

Identity = Base


class Rot90(Base):
    def __init__(self, axes=(0, 1)):
        self.axes = axes
        for a in self.axes:
            assert a > 0

    def sample(self, *shape):
        shape = list(shape)
        i, j = self.axes[0] - 1, self.axes[1] - 1
        shape[i], shape[j] = shape[j], shape[i]
        return shape

    def tf(self, img, k=0):
        return np.rot90(img, axes=self.axes)

    def __str__(self):
        return "Rot90(axes=({}, {})".format(*self.axes)


class RandomRotion(Base):
    def __init__(self, angle_spectrum=10):
        assert isinstance(angle_spectrum, int)
        self.angle_spectrum = angle_spectrum
        self.axes = [(1, 0), (2, 1), (2, 0)]

    def sample(self, *shape):
        self.axes_buffer = self.axes[np.random.choice(list(range(len(self.axes))))]
        self.angle_buffer = np.random.randint(-self.angle_spectrum, self.angle_spectrum)
        return list(shape)

    def tf(self, img, k=0):
        bsize = img.shape[0]
        img = img.copy()
        for bs in range(bsize):
            if k == 0 and img.ndim == 5:
                channels = [
                    ndimage.rotate(
                        img[bs, :, :, :, c], self.angle_buffer, axes=self.axes_buffer,
                        reshape=False, order=0, mode="constant", cval=-1,
                    )
                    for c in range(img.shape[4])
                ]
                img[bs, ...] = np.stack(channels, axis=-1)
            else:
                img[bs, ...] = ndimage.rotate(
                    img[bs, ...], self.angle_buffer, axes=self.axes_buffer,
                    reshape=False, order=0, mode="constant", cval=-1,
                )
        return img

    def __str__(self):
        return "RandomRotion(axes={},Angle:{}".format(self.axes_buffer, self.angle_buffer)


class Flip(Base):
    def __init__(self, axis=0):
        self.axis = axis

    def tf(self, img, k=0):
        return np.flip(img, self.axis)

    def __str__(self):
        return "Flip(axis={})".format(self.axis)


class RandomFlip(Base):
    def __init__(self, axis=0):
        self.axis = (1, 2, 3)

    def sample(self, *shape):
        self.x_buffer = np.random.choice([True, False])
        self.y_buffer = np.random.choice([True, False])
        self.z_buffer = np.random.choice([True, False])
        return list(shape)

    def tf(self, img, k=0):
        if self.x_buffer:
            img = np.flip(img, axis=self.axis[0])
        if self.y_buffer:
            img = np.flip(img, axis=self.axis[1])
        if self.z_buffer:
            img = np.flip(img, axis=self.axis[2])
        return img


class RandSelect(Base):
    def __init__(self, prob=0.5, tf=None):
        self.prob = prob
        self.ops = tf if isinstance(tf, (list, tuple)) else (tf,)
        self.buff = False

    def sample(self, *shape):
        self.buff = random.random() < self.prob
        if self.buff:
            for op in self.ops:
                shape = op.sample(*shape)
        return shape

    def tf(self, img, k=0):
        if self.buff:
            for op in self.ops:
                img = op.tf(img, k)
        return img

    def __str__(self):
        ops = (
            str(self.ops[0])
            if len(self.ops) == 1
            else "[{}]".format(", ".join(str(op) for op in self.ops))
        )
        return "RandSelect({}, {})".format(self.prob, ops)


class CenterCrop(Base):
    def __init__(self, size):
        self.size = size
        self.buffer = None

    def sample(self, *shape):
        size = self.size
        start = [(s - size) // 2 for s in shape]
        self.buffer = [slice(None)] + [slice(s, s + size) for s in start]
        return [size] * len(shape)

    def tf(self, img, k=0):
        return img[tuple(self.buffer)]

    def __str__(self):
        return "CenterCrop({})".format(self.size)


class CenterCropBySize(CenterCrop):
    def sample(self, *shape):
        assert len(self.size) == 3
        size = list(self.size)
        start = [(s - i) // 2 for i, s in zip(size, shape)]
        self.buffer = [slice(None)] + [slice(s, s + i) for i, s in zip(size, start)]
        return size

    def __str__(self):
        return "CenterCropBySize({})".format(self.size)


class RandCrop(CenterCrop):
    def sample(self, *shape):
        size = self.size
        start = [random.randint(0, s - size) for s in shape]
        self.buffer = [slice(None)] + [slice(s, s + size) for s in start]
        return [size] * len(shape)

    def __str__(self):
        return "RandCrop({})".format(self.size)


class RandCrop3D(CenterCrop):
    def sample(self, *shape):
        assert len(self.size) == 3
        size = list(self.size)
        start = [random.randint(0, s - i) for i, s in zip(size, shape)]
        self.buffer = [slice(None)] + [slice(s, s + k) for s, k in zip(start, size)]
        return size

    def __str__(self):
        return "RandCrop({})".format(self.size)


class RandomIntensityChange(Base):
    def __init__(self, factor):
        shift, scale = factor
        assert (shift > 0) and (scale > 0)
        self.shift, self.scale = shift, scale

    def tf(self, img, k=0):
        if k == 1:
            return img
        shift_factor = np.random.uniform(
            -self.shift, self.shift, size=[1, img.shape[1], 1, 1, img.shape[4]]
        )
        scale_factor = np.random.uniform(
            1.0 - self.scale, 1.0 + self.scale, size=[1, img.shape[1], 1, 1, img.shape[4]]
        )
        return img * scale_factor + shift_factor


class RandomGammaCorrection(Base):
    def __init__(self, factor):
        lower, upper = factor
        assert (lower > 0) and (upper > 0)
        self.lower, self.upper = lower, upper

    def tf(self, img, k=0):
        if k == 1:
            return img
        img = img + np.min(img)
        img_max = np.max(img)
        img = img / img_max
        factor = random.choice(np.arange(self.lower, self.upper, 0.1))
        gamma = random.choice([1, factor])
        if gamma == 1:
            return img
        img = img ** gamma * img_max
        return (img - img.mean()) / img.std()


class MinMax_norm(Base):
    def tf(self, img, k=0):
        if k == 1:
            return img
        return (img - img.min()) / (img.max() - img.min())


class Seg_norm_7regions_FAIM(Base):
    """7-region LPBA grouping (`RDN/data/trans.py:334-360`)."""

    def __init__(self):
        frontal = list(range(21, 35))
        parietal = list(range(41, 51))
        occipital = list(range(61, 69))
        temporal = list(range(81, 93))
        cingulate = [101, 102, 121, 122]
        hippocampus = [165, 166]
        putamen = [163, 164]
        self.seg_table = [frontal, parietal, occipital, temporal, cingulate,
                          hippocampus, putamen]

    def tf(self, img, k=0):
        if k == 0:
            return img
        img_out = np.zeros_like(img)
        for i in range(1, len(self.seg_table) + 1):
            for index in self.seg_table[i - 1]:
                img_out[img == index] = i
        return img_out


class Resize_img(Base):
    def __init__(self, shape):
        self.shape = shape

    def tf(self, img, k=0):
        order = 0 if k == 1 else 3
        zoom = [1.0] + [t / s for t, s in zip(self.shape, img.shape[1:4])]
        if img.ndim == 5:
            zoom = zoom + [1.0]
        return ndimage.zoom(img, zoom, order=order)


class Pad(Base):
    def __init__(self, pad):
        self.pad = pad
        self.px = tuple(zip([0] * len(pad), pad))

    def sample(self, *shape):
        shape = list(shape)
        for i in range(len(shape)):
            shape[i] += self.pad[i + 1]
        return shape

    def tf(self, img, k=0):
        dim = len(img.shape)
        return np.pad(img, self.px[:dim], mode="constant")

    def __str__(self):
        return "Pad(({}, {}, {}))".format(*self.pad)


class Pad3DIfNeeded(Base):
    def __init__(self, shape, value=0, mask_value=0):
        self.shape = shape
        self.value = value
        self.mask_value = mask_value

    def tf(self, img, k=0):
        pad = [(0, 0)]
        img_shape = img.shape[1:-1] if k == 0 else img.shape[1:]
        for i, t in zip(img_shape, self.shape):
            if i < t:
                diff = t - i
                pad.append((math.ceil(diff / 2), math.floor(diff / 2)))
            else:
                pad.append((0, 0))
        if k == 0:
            pad.append((0, 0))
        if k == 0:
            return np.pad(img, tuple(pad), mode="constant", constant_values=img.min())
        return np.pad(img, tuple(pad), mode="constant", constant_values=self.mask_value)


class Noise(Base):
    def __init__(self, dim, sigma=0.1, channel=True, num=-1):
        self.dim = dim
        self.sigma = sigma
        self.channel = channel
        self.num = num

    def tf(self, img, k=0):
        if self.num > 0 and k >= self.num:
            return img
        if self.channel:
            shape = [1] if len(img.shape) < self.dim + 2 else [img.shape[-1]]
        else:
            shape = img.shape
        return img * np.exp(self.sigma * np.random.randn(*shape).astype(np.float32))

    def __str__(self):
        return "Noise()"


class GaussianBlur(Base):
    def __init__(self, dim, sigma=Constant(1.5), app=-1):
        self.dim = dim
        self.sigma = sigma
        self.eps = 0.001
        # the reference's tf() reads self.num but only sets self.app —
        # a latent crash (`RDN/data/trans.py:452`); app == num here
        self.num = app

    def tf(self, img, k=0):
        if self.num > 0 and k >= self.num:
            return img
        img = img.copy()
        for n in range(img.shape[0]):
            sig = self.sigma.sample()
            if sig > self.eps:
                if len(img.shape) == self.dim + 2:
                    for c in range(img.shape[-1]):
                        img[n, ..., c] = ndimage.gaussian_filter(img[n, ..., c], sig)
                elif len(img.shape) == self.dim + 1:
                    img[n] = ndimage.gaussian_filter(img[n], sig)
                else:
                    raise ValueError("image shape is not supported")
        return img

    def __str__(self):
        return "GaussianBlur()"


class Normalize(Base):
    def __init__(self, mean=0.0, std=1.0, num=-1):
        self.mean, self.std, self.num = mean, std, num

    def tf(self, img, k=0):
        if self.num > 0 and k >= self.num:
            return img
        return (img - self.mean) / self.std

    def __str__(self):
        return "Normalize()"
