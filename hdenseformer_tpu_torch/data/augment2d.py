"""2-D augmentations: erase, flip, rotate, zoom, gamma, noise, elastic.

A copy of ``hdenseformer_tpu/data/augment2d.py`` (the port imports nothing
of the JAX package): the same classes, drawing from the same explicit
``numpy.random.Generator`` in the same order, so one seed gives the
same sample in both packages. Like JAX's they use cv2 where it imports and
scipy otherwise (set the module's ``cv2`` to None for the scipy branch):

- RandomErase2D: zero out one side around the ROI's bounding box;
- RandomFlip2D: 'hv' flips W when p < 0.3, H when p < 0.6;
- RandomRotate2D: a choice of +-{0, 5, 10, 15} degrees about the image
  centre, bilinear image and nearest label, zeros outside;
- RandomZoom2D: an ROI-aware crop (scale < 1) or a random pad (scale > 1),
  resized back, bilinear image and nearest label;
- RandomAdjust2D: gamma in [0.8, 1.2] on the non-negative part;
- RandomNoise2D: with p = 0.1, gaussian noise of sigma 0.1, clipped to [0, 1];
- RandomDistort2D: an elastic grid distortion, a blurred coarse
  displacement grid upsampled and applied with a reflecting border.
"""
from __future__ import annotations

import numpy as np

try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None

from scipy import ndimage


def _rotate(img: np.ndarray, deg: float, order: int) -> np.ndarray:
    """Rotate about the image center, output same size, zeros outside."""
    h, w = img.shape
    if cv2 is not None:
        m = cv2.getRotationMatrix2D((w / 2 - 0.5, h / 2 - 0.5), deg, 1.0)
        flag = cv2.INTER_LINEAR if order == 1 else cv2.INTER_NEAREST
        return cv2.warpAffine(
            img.astype(np.float32), m, (w, h), flags=flag,
            borderMode=cv2.BORDER_CONSTANT, borderValue=0,
        )
    a = np.deg2rad(deg)
    c, s = np.cos(a), np.sin(a)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    ys = c * (yy - cy) - s * (xx - cx) + cy
    xs = s * (yy - cy) + c * (xx - cx) + cx
    return ndimage.map_coordinates(
        img.astype(np.float32), [ys, xs], order=order, mode="constant", cval=0.0
    )


def _resize2d(img: np.ndarray, out_hw, order: int) -> np.ndarray:
    if cv2 is not None:
        flag = cv2.INTER_LINEAR if order == 1 else cv2.INTER_NEAREST
        return cv2.resize(img.astype(np.float32), (out_hw[1], out_hw[0]), interpolation=flag)
    from hdenseformer_tpu_torch.data.transforms import resize_half_pixel

    if order == 0:
        idx0 = np.floor(np.arange(out_hw[0]) * img.shape[0] / out_hw[0]).astype(int)
        idx1 = np.floor(np.arange(out_hw[1]) * img.shape[1] / out_hw[1]).astype(int)
        return img[np.ix_(idx0, idx1)].astype(np.float32)
    return resize_half_pixel(img, out_hw, order=1)


class RandomErase2D:
    def __init__(self, window_size=(64, 64), scale_flag: bool = True):
        self.window_size = window_size
        self.scale_flag = scale_flag

    def __call__(self, sample, rng: np.random.Generator):
        if self.scale_flag:
            hf = rng.uniform(0.5, 1)
            wf = rng.uniform(0.5, 1)
            max_h, max_w = int(self.window_size[0] * hf), int(self.window_size[1] * wf)
        else:
            max_h, max_w = self.window_size
        image = sample["image"]
        label = sample["label"]
        mm = 1 if image.ndim > 2 else 0
        h, w = label.shape
        window = []
        if np.sum(label) != 0:
            nz = np.nonzero(label)
            window.append((
                max(int(np.amin(nz[0])) - max_h // 2, 0),
                min(int(np.amax(nz[0])) + max_h // 2, h),
            ))
            window.append((
                max(int(np.amin(nz[1])) - max_w // 2, 0),
                min(int(np.amax(nz[1])) + max_w // 2, w),
            ))
        else:
            window.append((int(rng.integers(0, 65)), int(rng.integers(-64, 1))))
            window.append((int(rng.integers(0, 65)), int(rng.integers(-64, 1))))
        direction = ["t", "d", "l", "r", "no_erase"][int(rng.integers(0, 5))]
        image = image.copy()
        if direction == "t":
            image[..., : window[0][0], :] = 0
        elif direction == "d":
            image[..., window[0][1]:, :] = 0
        elif direction == "l":
            image[..., :, : window[1][0]] = 0
        elif direction == "r":
            image[..., :, window[1][1]:] = 0
        sample["image"] = image
        return sample


class RandomFlip2D:
    def __init__(self, mode: str = "hv"):
        self.mode = mode

    def __call__(self, sample, rng: np.random.Generator):
        image = sample["image"]
        label = sample["label"]
        if "h" in self.mode and "v" in self.mode:
            r = rng.uniform(0, 1)
            if r < 0.3:
                image = np.flip(image, axis=-1)
                label = np.flip(label, axis=-1)
            elif r < 0.6:
                image = np.flip(image, axis=-2)
                label = np.flip(label, axis=-2)
        elif "h" in self.mode:
            if rng.uniform(0, 1) > 0.5:
                image = np.flip(image, axis=-1)
                label = np.flip(label, axis=-1)
        elif "v" in self.mode:
            if rng.uniform(0, 1) > 0.5:
                image = np.flip(image, axis=-2)
                label = np.flip(label, axis=-2)
        sample["image"] = np.ascontiguousarray(image)
        sample["label"] = np.ascontiguousarray(label)
        return sample


class RandomRotate2D:
    def __init__(self, degree=(-15, -10, -5, 0, 5, 10, 15)):
        self.degree = list(degree)

    def __call__(self, sample, rng: np.random.Generator):
        image = sample["image"]
        label = sample["label"]
        deg = self.degree[int(rng.integers(0, len(self.degree)))]
        if image.ndim > 2:
            image = np.stack([_rotate(image[i], deg, 1) for i in range(image.shape[0])])
        else:
            image = _rotate(image, deg, 1)
        label = _rotate(label.astype(np.float32), deg, 0)
        sample["image"] = image.astype(np.float32)
        sample["label"] = label.astype(np.float32)
        return sample


class RandomZoom2D:
    def __init__(self, scale=(0.8, 1.2)):
        assert isinstance(scale, tuple)
        self.scale = scale

    def __call__(self, sample, rng: np.random.Generator):
        image = sample["image"]
        label = sample["label"]
        mm = 1 if image.ndim > 2 else 0
        h, w = label.shape
        factor = rng.uniform(self.scale[0], self.scale[1])
        th, tw = int(h * factor), int(w * factor)

        chans = [image[i] for i in range(image.shape[0])] if mm else [image]
        if factor < 1.0:
            nz = np.nonzero(label)
            if len(nz[0]) == 0:
                y0 = int(rng.integers(0, h - th, endpoint=True))
                x0 = int(rng.integers(0, w - tw, endpoint=True))
            else:
                y_lo, y_hi = int(np.min(nz[0])), int(np.max(nz[0]))
                x_lo, x_hi = int(np.min(nz[1])), int(np.max(nz[1]))
                y_min = max(0, min(y_lo, y_hi - th))
                y_max = min(y_lo, h - th)
                x_min = max(0, min(x_lo, x_hi - tw))
                x_max = min(x_lo, w - tw)
                y0 = int(rng.integers(min(y_min, y_max), max(y_min, y_max), endpoint=True))
                x0 = int(rng.integers(min(x_min, x_max), max(x_min, x_max), endpoint=True))
            chans = [c[y0 : y0 + th, x0 : x0 + tw] for c in chans]
            label_c = label[y0 : y0 + th, x0 : x0 + tw]
        else:
            ph, pw = th - h, tw - w
            top = int(rng.uniform(0, ph / 2))
            left = int(rng.uniform(0, pw / 2))
            pad = ((top, ph - top), (left, pw - left))
            chans = [np.pad(c, pad, mode="constant") for c in chans]
            label_c = np.pad(label, pad, mode="constant")

        chans = [_resize2d(c, (h, w), 1) for c in chans]
        label_c = _resize2d(label_c.astype(np.float32), (h, w), 0)
        sample["image"] = (np.stack(chans) if mm else chans[0]).astype(np.float32)
        sample["label"] = label_c.astype(np.float32)
        return sample


class RandomAdjust2D:
    def __init__(self, scale=(0.8, 1.2)):
        assert isinstance(scale, tuple)
        self.scale = scale

    def __call__(self, sample, rng: np.random.Generator):
        image = np.asarray(sample["image"], dtype=np.float32)
        gamma = rng.uniform(self.scale[0], self.scale[1])
        sample["image"] = np.power(np.maximum(image, 0), gamma).astype(np.float32)
        return sample


class RandomNoise2D:
    def __call__(self, sample, rng: np.random.Generator):
        if rng.uniform(0, 1) > 0.9:
            image = np.asarray(sample["image"], dtype=np.float32)
            noisy = image + rng.normal(0.0, 0.1, size=image.shape)
            sample["image"] = np.clip(noisy, 0.0, 1.0).astype(np.float32)
        return sample


class RandomDistort2D:
    def __init__(self, alpha=200, sigma=20, grid_scale=4, prob=0.5):
        self.alpha = alpha
        self.sigma = sigma
        self.grid_scale = grid_scale
        self.prob = prob

    def __call__(self, sample, rng: np.random.Generator):
        if rng.uniform(0, 1) <= self.prob:
            return sample
        image = sample["image"]
        label = sample["label"]
        mm = 1 if image.ndim > 2 else 0
        h, w = label.shape
        alpha = self.alpha // self.grid_scale
        sigma = self.sigma // self.grid_scale
        gh, gw = h // self.grid_scale, w // self.grid_scale

        def disp():
            grid = (rng.random((gh, gw)) * 2 - 1).astype(np.float32)
            if cv2 is not None:
                blur = int(4 * sigma) | 1
                d = cv2.GaussianBlur(grid, (blur, blur), sigma) * alpha
                return cv2.resize(d, (w, h))
            d = ndimage.gaussian_filter(grid, sigma, mode="mirror") * alpha
            from hdenseformer_tpu_torch.data.transforms import resize_half_pixel

            return resize_half_pixel(d, (h, w))

        dx, dy = disp(), disp()
        yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        map_x = (xx + dx).astype(np.float32)
        map_y = (yy + dy).astype(np.float32)

        def remap(img):
            if cv2 is not None:
                return cv2.remap(
                    img.astype(np.float32), map_x, map_y,
                    borderMode=cv2.BORDER_REFLECT_101,
                    interpolation=cv2.INTER_LINEAR,
                )
            return ndimage.map_coordinates(
                img.astype(np.float32), [map_y, map_x], order=1, mode="reflect"
            )

        if mm:
            image = np.stack([remap(image[i]) for i in range(image.shape[0])])
        else:
            image = remap(image)
        sample["image"] = image.astype(np.float32)
        sample["label"] = remap(label).astype(np.float32)
        return sample
