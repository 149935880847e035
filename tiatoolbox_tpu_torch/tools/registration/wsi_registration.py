"""Whole-slide registration (counterpart of
``tiatoolbox_tpu/tools/registration/wsi_registration.py``).

Each part reproduces the JAX lines it names:

- ``compute_center_of_mass``, ``apply_affine_transformation``,
  ``_to_grey_float``, ``match_histograms`` and ``prealignment`` (:29-169)
  run on the host, their warps, blurs and greyscale through the port's
  OpenCV-exact ``utils.warp`` and ``utils.misc.rgb2gray_u8``, so the
  rotation search scores the masks JAX scores and picks its angle;
- ``DFBRFeatureExtractor`` (:172-203) runs VGG16's trunk on the device
  (``resolve_device``: the card unless the caller asks for the CPU); with
  no weights it draws torchvision's initialisation from a seeded
  generator and warns as JAX does;
- ``DFBRegister`` (:206-368) resizes with ``resize_linear`` (:233), then
  matches features and fits the affine in numpy on the host, as JAX does;
- ``estimate_bspline_transform`` (:371-448) optimises the control-point
  displacements on the device: the dense field is two small products with
  ``cubic_resize_weights`` (``jax.image.resize``'s Keys kernel, a = -0.5,
  outside taps dropped and each row renormalised, widened when it
  shrinks), the warp is ``map_coordinates(order=1, mode="nearest")`` as a
  floor, clamp and gather that autograd differentiates, the loss is the
  masked MSE plus ``smoothness`` times the mean squared control
  differences (:420-433), and Adam is optax's ``adam`` written out in its
  order. The loop reads nothing back to the host until it ends;
- ``apply_bspline_transform`` (:451-464) and ``AffineWSITransformer``
  (:467-523) on the host through ``remap_linear`` and ``warp_affine``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from tiatoolbox_tpu_torch import logger, resolve_device
from tiatoolbox_tpu_torch.utils.metrics import dice
from tiatoolbox_tpu_torch.utils.misc import rgb2gray_u8
from tiatoolbox_tpu_torch.utils.transforms import imresize
from tiatoolbox_tpu_torch.utils.warp import box_blur, remap_linear, resize_linear, warp_affine

BIN_MASK_DIM = 2
# optax.adam's defaults (b1, b2, eps, eps_root)
ADAM_B1, ADAM_B2, ADAM_EPS, ADAM_EPS_ROOT = 0.9, 0.999, 1e-8, 0.0
DFBR_SEED = 0  # the seeded VGG16 initialisation without a checkpoint


def compute_center_of_mass(mask: np.ndarray) -> tuple[float, float]:
    """Center of mass (x, y) of a weight/mask image."""
    total = float(np.sum(mask))
    if total == 0:
        return (mask.shape[1] / 2, mask.shape[0] / 2)
    ys, xs = np.mgrid[0 : mask.shape[0], 0 : mask.shape[1]]
    return (float((xs * mask).sum() / total), float((ys * mask).sum() / total))


def apply_affine_transformation(
    fixed_img: np.ndarray, moving_img: np.ndarray, transform: np.ndarray
) -> np.ndarray:
    """Warp moving image onto the fixed image frame with a 3x3 transform."""
    return warp_affine(moving_img, transform[0:-1][:], fixed_img.shape[:2][::-1])


def _to_grey_float(img: np.ndarray) -> np.ndarray:
    img = np.squeeze(img)
    if img.ndim == 3:
        img = rgb2gray_u8(img.astype(np.uint8))
    img = img.astype(np.float64)
    if img.max() > 1:
        img = img / 255.0
    return img


def match_histograms(
    image_a: np.ndarray, image_b: np.ndarray, kernel_size: int = 7
) -> tuple[np.ndarray, np.ndarray]:
    """Match image_b's intensity histogram to image_a's (and smooth both)."""
    image_a = np.squeeze(image_a)
    image_b = np.squeeze(image_b)
    a_vals, a_counts = np.unique(image_a.ravel(), return_counts=True)
    b_vals, b_counts = np.unique(image_b.ravel(), return_counts=True)
    a_quantiles = np.cumsum(a_counts) / image_a.size
    b_quantiles = np.cumsum(b_counts) / image_b.size
    interp = np.interp(b_quantiles, a_quantiles, a_vals)
    matched = interp[np.searchsorted(b_vals, image_b.ravel())].reshape(image_b.shape)
    matched = matched.astype(image_a.dtype)
    kernel = (kernel_size, kernel_size)
    return box_blur(image_a, kernel), box_blur(matched, kernel)


def _check_dims(fixed_img, moving_img, fixed_mask, moving_mask):
    if np.count_nonzero(fixed_mask) == 0 or np.count_nonzero(moving_mask) == 0:
        msg = "The foreground is missing in the mask."
        raise ValueError(msg)
    if (
        fixed_img.shape[:2] != fixed_mask.shape[:2]
        or moving_img.shape[:2] != moving_mask.shape[:2]
    ):
        msg = "Mismatch of shape between image and its corresponding mask."
        raise ValueError(msg)
    return _to_grey_float(fixed_img), _to_grey_float(moving_img)


def prealignment(
    fixed_img: np.ndarray,
    moving_img: np.ndarray,
    fixed_mask: np.ndarray,
    moving_mask: np.ndarray,
    dice_overlap: float = 0.5,
    rotation_step: int = 10,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """Coarse rigid alignment via COM translation + rotation search.

    Returns (3x3 transform, warped moving image, warped mask, dice).
    """
    orig_fixed_img, orig_moving_img = fixed_img, moving_img
    if len(fixed_mask.shape) != BIN_MASK_DIM:
        fixed_mask = fixed_mask[:, :, 0]
    if len(moving_mask.shape) != BIN_MASK_DIM:
        moving_mask = moving_mask[:, :, 0]
    fixed_mask = (fixed_mask > 0).astype(np.uint8)
    moving_mask = (moving_mask > 0).astype(np.uint8)

    fixed_grey, moving_grey = _check_dims(
        np.squeeze(fixed_img), np.squeeze(moving_img), fixed_mask, moving_mask
    )
    if rotation_step < 10 or rotation_step > 20:
        msg = "Please select the rotation step in between 10 and 20."
        raise ValueError(msg)
    if dice_overlap < 0 or dice_overlap > 1:
        msg = "The dice_overlap should be in between 0 and 1.0."
        raise ValueError(msg)

    height = max(fixed_mask.shape[0], moving_mask.shape[0])
    width = max(fixed_mask.shape[1], moving_mask.shape[1])
    padded_fixed = np.pad(
        fixed_mask,
        [(0, height - fixed_mask.shape[0]), (0, width - fixed_mask.shape[1])],
    )
    padded_moving = np.pad(
        moving_mask,
        [(0, height - moving_mask.shape[0]), (0, width - moving_mask.shape[1])],
    )
    dice_before = dice(padded_fixed, padded_moving)

    fixed_com = compute_center_of_mass((1 - fixed_grey) * fixed_mask)
    moving_com = compute_center_of_mass((1 - moving_grey) * moving_mask)

    com_transform = np.array(
        [
            [1, 0, fixed_com[0] - moving_com[0]],
            [0, 1, fixed_com[1] - moving_com[1]],
            [0, 0, 1],
        ]
    )
    to_origin = np.array([[1, 0, -fixed_com[0]], [0, 1, -fixed_com[1]], [0, 0, 1]])
    from_origin = np.array([[1, 0, fixed_com[0]], [0, 1, fixed_com[1]], [0, 0, 1]])

    all_dice, all_transform = [], []
    for angle in np.arange(0, 360, rotation_step):
        theta = np.radians(angle)
        c, s = np.cos(theta), np.sin(theta)
        rotation = np.array(((c, -s, 0), (s, c, 0), (0, 0, 1)))
        transform = from_origin @ rotation @ to_origin @ com_transform
        warped_mask = warp_affine(moving_mask, transform[0:-1][:], fixed_grey.shape[:2][::-1])
        all_dice.append(dice(fixed_mask, warped_mask))
        all_transform.append(transform)

    if max(all_dice) >= dice_overlap:
        dice_after = max(all_dice)
        pre_transform = all_transform[int(np.argmax(all_dice))]
        moving_out = apply_affine_transformation(
            orig_fixed_img, orig_moving_img, pre_transform
        )
        mask_out = apply_affine_transformation(
            fixed_grey, moving_mask, pre_transform
        )
        return pre_transform, moving_out, mask_out, dice_after

    logger.warning(
        "Not able to find the best transformation for pre-alignment. "
        "Try changing the values for 'dice_overlap' and 'rotation_step'.",
    )
    return np.eye(3), orig_moving_img, moving_mask, dice_before


def _vgg16_state_from_file(path: str | Path) -> dict[str, torch.Tensor]:
    """VGG16 trunk weights from a flax ``.npz`` or a torchvision ``vgg16``
    checkpoint (``.pth``/``.tar``)."""
    from tiatoolbox_tpu_torch.models.architecture import unwrap_checkpoint
    from tiatoolbox_tpu_torch.models.architecture.weight_converter import (
        flax_vgg_to_torch,
        load_flax_npz,
        torchvision_vgg16_features,
    )

    path = Path(path)
    if path.suffix == ".npz":
        return flax_vgg_to_torch(load_flax_npz(path))
    return torchvision_vgg16_features(unwrap_checkpoint(torch.load(path, map_location="cpu", weights_only=True)))


class DFBRFeatureExtractor:
    """VGG16 block3/4/5-pool features (reference
    ``wsi_registration.py:329-412``; torchvision layer ids 16/23/30).

    ImageNet weights load by name from a torchvision ``vgg16`` checkpoint
    or a flax ``.npz``; without one the trunk takes torchvision's
    initialisation from a seeded generator, with a warning.

    Args:
        patch_size: Input (height, width).
        weights: Optional checkpoint path.
        device: Where the trunk runs (``rcParam["device"]`` by default).
    """

    def __init__(self, patch_size=(224, 224), weights=None, device=None) -> None:
        from tiatoolbox_tpu_torch.models.architecture.vgg import VGG16Features, seeded_vgg16_state

        self.patch_size = patch_size
        self.device = resolve_device(device)
        self.model = VGG16Features()
        if weights is not None:
            state = _vgg16_state_from_file(weights)
        else:
            logger.warning(
                "DFBR: no VGG16 weights given; using random init "
                "(pass a torchvision vgg16 checkpoint for reference parity)."
            )
            state = seeded_vgg16_state(DFBR_SEED)
        self.model.load_state_dict(state)
        self.model.to(self.device).eval()

    def __call__(self, img: np.ndarray) -> list[np.ndarray]:
        """uint8 ``[h, w, 3]`` -> the three pool outputs, each ``[h', w', c]``."""
        x = torch.from_numpy(np.ascontiguousarray(img[None])).to(self.device)
        x = x.permute(0, 3, 1, 2).float() / 255.0
        with torch.inference_mode():
            feats = self.model(x)
        return [f[0].permute(1, 2, 0).cpu().numpy() for f in feats]


class DFBRegister:
    """Deep-feature block registration (DFBR).

    Matches multi-stage CNN features between a fixed and moving image
    and estimates a robust affine transform. Feature extraction uses
    the reference's VGG16 block3/4/5-pool hooks (see
    ``DFBRFeatureExtractor``), on ``device``.

    Args:
        patch_size: Feature extraction input size.
        weights: Optional torchvision vgg16 checkpoint (.pth/.npz) for
            ImageNet features (reference behavior).
        device: Where VGG16 runs (``rcParam["device"]`` by default).
    """

    def __init__(
        self, patch_size: tuple[int, int] = (224, 224), weights=None, device=None
    ) -> None:
        self.patch_size = patch_size
        self._weights = weights
        self._device = resolve_device(device)
        self._extractor = None

    def _features(self, img: np.ndarray) -> list[np.ndarray]:
        """Multi-stage feature maps for an RGB image."""
        if self._extractor is None:
            self._extractor = DFBRFeatureExtractor(
                self.patch_size, weights=self._weights, device=self._device
            )
        img_resized = resize_linear(img.astype(np.uint8), self.patch_size[::-1])
        return self._extractor(img_resized)

    @staticmethod
    def finding_match(feature_dist: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Mutually-nearest feature matches + quality ratios."""
        seq = np.arange(feature_dist.shape[0])
        ind_first_min = np.argmin(feature_dist, axis=1)
        first_min = feature_dist[seq, ind_first_min]
        mask = np.zeros_like(feature_dist)
        mask[seq, ind_first_min] = 1
        masked = np.ma.masked_array(feature_dist, mask)
        second_min = np.amin(masked, axis=1)
        ratio = np.array(second_min / np.maximum(first_min, 1e-12))
        matches = np.stack([seq, ind_first_min], axis=1)
        return matches, ratio

    def _match_features(
        self, fixed_feats: list[np.ndarray], moving_feats: list[np.ndarray]
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Match pooled feature vectors across scales; return point pairs."""
        fixed_points, moving_points, qualities = [], [], []
        for f_map, m_map in zip(fixed_feats, moving_feats):
            fh, fw, fc = f_map.shape
            f_flat = f_map.reshape(-1, fc)
            m_flat = m_map.reshape(-1, fc)
            f_norm = f_flat / np.maximum(
                np.linalg.norm(f_flat, axis=1, keepdims=True), 1e-12
            )
            m_norm = m_flat / np.maximum(
                np.linalg.norm(m_flat, axis=1, keepdims=True), 1e-12
            )
            distance = 1 - f_norm @ m_norm.T
            matches, ratio = self.finding_match(distance)
            grid_y, grid_x = np.mgrid[0:fh, 0:fw]
            coords = np.stack([grid_x.ravel(), grid_y.ravel()], axis=1)
            # convert grid coords to [0, 1] relative positions
            rel = (coords + 0.5) / np.array([fw, fh])
            fixed_points.append(rel[matches[:, 0]])
            moving_points.append(rel[matches[:, 1]])
            qualities.append(ratio)
        return (
            np.concatenate(fixed_points),
            np.concatenate(moving_points),
            np.concatenate(qualities),
        )

    @staticmethod
    def estimate_affine(
        fixed_points: np.ndarray, moving_points: np.ndarray
    ) -> np.ndarray:
        """Least-squares affine moving→fixed from point pairs."""
        n = len(fixed_points)
        a = np.zeros((2 * n, 6))
        b = np.zeros(2 * n)
        a[0::2, 0:2] = moving_points
        a[0::2, 2] = 1
        a[1::2, 3:5] = moving_points
        a[1::2, 5] = 1
        b[0::2] = fixed_points[:, 0]
        b[1::2] = fixed_points[:, 1]
        params, *_ = np.linalg.lstsq(a, b, rcond=None)
        return np.array(
            [
                [params[0], params[1], params[2]],
                [params[3], params[4], params[5]],
                [0, 0, 1],
            ]
        )

    @staticmethod
    def estimate_affine_transform(
        points_0: np.ndarray, points_1: np.ndarray
    ) -> np.ndarray:
        """Reference-named alias (``wsi_registration.py:681``): linear
        least-squares affine mapping ``points_1`` onto ``points_0``."""
        return DFBRegister.estimate_affine(
            np.asarray(points_0), np.asarray(points_1)
        )

    @staticmethod
    def find_points_inside_boundary(
        mask: np.ndarray, points: np.ndarray
    ) -> np.ndarray:
        """Boolean mask of points inside a binary region (reference :784)."""
        points = np.asarray(points)
        cols = np.clip(points[:, 0].astype(int), 0, mask.shape[1] - 1)
        rows = np.clip(points[:, 1].astype(int), 0, mask.shape[0] - 1)
        inside = np.asarray(mask)[rows, cols] > 0
        # points outside the array bounds are never inside
        inside &= (points[:, 0] >= 0) & (points[:, 0] < mask.shape[1])
        inside &= (points[:, 1] >= 0) & (points[:, 1] < mask.shape[0])
        return inside

    def register(
        self,
        fixed_img: np.ndarray,
        moving_img: np.ndarray,
        fixed_mask: np.ndarray | None = None,
        moving_mask: np.ndarray | None = None,
        transform_initializer: np.ndarray | None = None,
        quality_threshold: float = 1.02,
    ) -> np.ndarray:
        """Estimate a 3x3 affine transform aligning moving → fixed.

        Uses deep-feature matches filtered by second/first-ratio
        quality, with iterative inlier refinement.
        """
        if transform_initializer is not None:
            moving_img = apply_affine_transformation(
                fixed_img, moving_img, transform_initializer
            )
        h, w = fixed_img.shape[:2]
        fixed_feats = self._features(fixed_img)
        moving_feats = self._features(moving_img)
        fixed_pts, moving_pts, quality = self._match_features(
            fixed_feats, moving_feats
        )
        keep = quality > quality_threshold
        if keep.sum() < 6:
            keep = np.argsort(-quality)[:32]
        fixed_pts = fixed_pts[keep] * [w, h]
        moving_pts = moving_pts[keep] * [w, h]

        transform = self.estimate_affine(fixed_pts, moving_pts)
        # one round of inlier refinement
        proj = (transform[:2, :2] @ moving_pts.T).T + transform[:2, 2]
        err = np.linalg.norm(proj - fixed_pts, axis=1)
        inliers = err < np.percentile(err, 70)
        if inliers.sum() >= 4:
            transform = self.estimate_affine(
                fixed_pts[inliers], moving_pts[inliers]
            )
        if transform_initializer is not None:
            transform = transform @ transform_initializer
        return transform


def cubic_resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """``[n_out, n_in]`` float32 weights of ``jax.image.resize(...,
    method="cubic")`` along one axis (``jax/_src/image/scale.py``,
    ``compute_weight_mat`` with ``antialias=True``): Keys' kernel with
    a = -0.5 at half-pixel centres, widened by the scale when shrinking,
    each output's weights renormalised over the taps inside the input, and
    zero where the sample lies outside it."""
    scale = n_out / n_in
    inv_scale = np.float32(1.0 / scale)
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    near = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1.0)
    far = ((np.float32(-0.5) * x + np.float32(2.5)) * x - np.float32(4.0)) * x + np.float32(2.0)
    weights = np.where(x >= 2.0, np.float32(0), np.where(x >= 1.0, far, near)).astype(np.float32)
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        weights / np.where(total != 0, total, 1),
        0,
    )
    inside = (sample >= -0.5) & (sample <= np.float32(n_in) - np.float32(0.5))
    return np.where(inside[None, :], weights, 0).astype(np.float32).T


def dense_field(control: torch.Tensor, weights_y: torch.Tensor, weights_x: torch.Tensor) -> torch.Tensor:
    """Control displacements ``[gh, gw, 2]`` -> the dense field ``[h, w, 2]``:
    ``weights_x`` along x, then ``weights_y`` along y, the order of JAX's
    contraction."""
    gh = control.shape[0]
    columns = weights_x @ control  # [gh, w, 2]
    return (weights_y @ columns.reshape(gh, -1)).reshape(weights_y.shape[0], -1, 2)


def sample_linear_nearest(image: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """``jax.scipy.ndimage.map_coordinates(image, [ys, xs], order=1,
    mode="nearest")``: floor, clamp and gather, the four products summed in
    its order. The weights carry the gradient; the gathered pixels do not."""
    h, w = image.shape
    flat = image.reshape(-1)
    y0, x0 = torch.floor(ys).detach(), torch.floor(xs).detach()
    wy1, wx1 = ys - y0, xs - x0
    wy0, wx0 = 1 - wy1, 1 - wx1
    iy0, ix0 = y0.long(), x0.long()
    iy = (iy0.clamp(0, h - 1) * w, (iy0 + 1).clamp(0, h - 1) * w)
    ix = (ix0.clamp(0, w - 1), (ix0 + 1).clamp(0, w - 1))
    out = (wy0 * wx0) * flat[iy[0] + ix[0]]
    out = out + (wy0 * wx1) * flat[iy[0] + ix[1]]
    out = out + (wy1 * wx0) * flat[iy[1] + ix[0]]
    return out + (wy1 * wx1) * flat[iy[1] + ix[1]]


def adam_step(control, grad, mu, nu, count: int, learning_rate: float):
    """One step of ``optax.adam(learning_rate)`` in optax's order: the
    moments, the bias corrections in float32 at step ``count`` (from 1),
    ``mu_hat / (sqrt(nu_hat + eps_root) + eps)``, scaled by
    ``-learning_rate`` and added. Returns (control, mu, nu)."""
    mu = (1 - ADAM_B1) * grad + ADAM_B1 * mu
    nu = (1 - ADAM_B2) * (grad * grad) + ADAM_B2 * nu
    step = np.float32(count)
    mu_hat = mu / float(np.float32(1) - np.float32(ADAM_B1) ** step)
    nu_hat = nu / float(np.float32(1) - np.float32(ADAM_B2) ** step)
    update = mu_hat / (torch.sqrt(nu_hat + ADAM_EPS_ROOT) + ADAM_EPS)
    return control + (-learning_rate) * update, mu, nu


def estimate_bspline_transform(
    fixed_image: np.ndarray,
    moving_image: np.ndarray,
    fixed_mask: np.ndarray | None = None,
    moving_mask: np.ndarray | None = None,
    grid_space: float = 50.0,
    n_iterations: int = 200,
    learning_rate: float = 0.5,
    smoothness: float = 0.05,
    device=None,
) -> np.ndarray:
    """Differentiable free-form-deformation registration on ``device``.

    Optimizes control-point displacements (spacing ``grid_space`` px)
    so the warped moving image matches the fixed image (masked MSE +
    displacement smoothness). Returns a dense displacement field
    [H, W, 2] (dx, dy) mapping fixed coords → moving coords. The
    reference delegates to SimpleITK B-splines
    (``wsi_registration.py:1255-1461``); this runs the optimisation as an
    autograd loop on the device.
    """
    dev = resolve_device(device)
    fixed = _to_grey_float(fixed_image)
    moving = _to_grey_float(moving_image)
    if moving.shape != fixed.shape:
        moving = resize_linear(moving, fixed.shape[::-1])
    h, w = fixed.shape
    mask = np.ones((h, w), np.float32)
    if fixed_mask is not None:
        mask *= (np.squeeze(fixed_mask) > 0).astype(np.float32)
    if moving_mask is not None:
        mm = (np.squeeze(moving_mask) > 0).astype(np.float32)
        if mm.shape != (h, w):
            mm = imresize(mm, output_size=(w, h), interpolation="nearest")
        mask *= mm

    gh = max(int(np.ceil(h / grid_space)) + 1, 4)
    gw = max(int(np.ceil(w / grid_space)) + 1, 4)
    fixed_t = torch.as_tensor(fixed, dtype=torch.float32, device=dev)
    moving_t = torch.as_tensor(moving, dtype=torch.float32, device=dev)
    mask_t = torch.as_tensor(mask, device=dev)
    mask_total = torch.clamp(mask_t.sum(), min=1.0)
    weights_y = torch.from_numpy(cubic_resize_weights(gh, h)).to(dev)
    weights_x = torch.from_numpy(cubic_resize_weights(gw, w)).to(dev)
    ys = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=dev, dtype=torch.float32)[None, :]

    def loss_fn(control: torch.Tensor) -> torch.Tensor:
        # masked MSE of the warped moving image plus the smoothness term (JAX :420-433)
        field = dense_field(control, weights_y, weights_x)
        warped = sample_linear_nearest(moving_t, ys + field[..., 1], xs + field[..., 0])
        mse = torch.sum(((warped - fixed_t) ** 2) * mask_t) / mask_total
        dx = torch.diff(control, dim=0)
        dy = torch.diff(control, dim=1)
        return mse + smoothness * (torch.mean(dx**2) + torch.mean(dy**2))

    control = torch.zeros((gh, gw, 2), dtype=torch.float32, device=dev)
    mu = torch.zeros_like(control)
    nu = torch.zeros_like(control)
    for count in range(1, n_iterations + 1):
        control.requires_grad_(True)
        (grad,) = torch.autograd.grad(loss_fn(control), control)
        with torch.no_grad():
            control, mu, nu = adam_step(control.detach(), grad, mu, nu, count, learning_rate)
    with torch.no_grad():
        return dense_field(control, weights_y, weights_x).cpu().numpy()


def apply_bspline_transform(
    fixed_image: np.ndarray,
    moving_image: np.ndarray,
    transform: np.ndarray,
) -> np.ndarray:
    """Warp moving image by a dense displacement field [H, W, 2]."""
    h, w = transform.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    map_x = xs + transform[..., 0].astype(np.float32)
    map_y = ys + transform[..., 1].astype(np.float32)
    moving = np.squeeze(moving_image)
    if moving.shape[:2] != (h, w):
        moving = resize_linear(moving, (w, h))
    return remap_linear(moving, map_x, map_y)


class AffineWSITransformer:
    """Read regions from a slide through an affine transform.

    Args:
        reader: WSIReader of the moving slide.
        transform: 3x3 affine at baseline (moving → fixed frame).
    """

    def __init__(self, reader, transform: np.ndarray) -> None:
        self.wsi_reader = reader
        self.transform_level0 = np.asarray(transform, dtype=float)

    def read_rect(
        self,
        location: tuple[int, int],
        size: tuple[int, int],
        resolution=0,
        units: str = "level",
        **kwargs,
    ) -> np.ndarray:
        """Read a rect in the *fixed* frame from the moving slide."""
        size = (int(size[0]), int(size[1]))
        # expand the source read to cover the inverse-transformed corners
        inv = np.linalg.inv(self.transform_level0)
        corners = np.array(
            [
                [location[0], location[1], 1],
                [location[0] + size[0], location[1], 1],
                [location[0], location[1] + size[1], 1],
                [location[0] + size[0], location[1] + size[1], 1],
            ]
        )
        src = (inv @ corners.T).T[:, :2]
        x0, y0 = np.floor(src.min(axis=0)).astype(int)
        x1, y1 = np.ceil(src.max(axis=0)).astype(int)
        pad = 2
        region = self.wsi_reader.read_bounds(
            (x0 - pad, y0 - pad, x1 + pad, y1 + pad),
            resolution=0,
            units="level",
            **kwargs,
        )
        # local transform mapping region pixels → output pixels
        local = self.transform_level0.copy()
        offset = np.array([x0 - pad, y0 - pad])
        shift_in = np.eye(3)
        shift_in[:2, 2] = offset
        shift_out = np.eye(3)
        shift_out[:2, 2] = -np.asarray(location, dtype=float)
        local = shift_out @ local @ shift_in
        warped = warp_affine(region, local[:2], size)
        if resolution not in (0, None) and units != "level":
            scales = self.wsi_reader.info.relative_level_scales(resolution, units)
            warped = imresize(warped, scale_factor=1 / scales[0][0])
        return warped
