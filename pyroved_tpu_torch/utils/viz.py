"""Plotting helpers (matplotlib).

Counterpart of ``pyroved_tpu/utils/viz.py``: a numpy tiler with
torchvision ``make_grid``'s d-by-d layout, and the plots the models'
``manifold2d``, ``manifold_traversal`` and ``predict_on_latent`` show.
Every function takes torch tensors (on any device) or numpy arrays.
matplotlib is imported by the plotting functions only, so the package
imports where it is absent.
"""
from typing import Sequence

import numpy as np

from .nn import as_numpy


def make_img_grid(imgdata, nrow: int, padding: int = 2, pad_value: float = 0.0) -> np.ndarray:
    """Tile a stack of images [N, H, W] (or channels-last [N, H, W, C],
    C in {3, 4} kept as RGB(A)) into one canvas, matching torchvision
    ``make_grid`` layout (row-major, ``padding`` pixels of ``pad_value``
    between tiles and around the border)."""
    imgs = as_numpy(imgdata)
    if imgs.ndim == 4 and imgs.shape[-1] not in (3, 4):
        if imgs.shape[-1] != 1 and imgs.shape[1] != 1:
            raise ValueError(
                f"cannot render images of shape {imgs.shape} as a grid: "
                "expected channels-LAST [N, H, W] / [N, H, W, C] with C in "
                "{1, 3, 4} — transpose channels-first input, or slice a "
                "channel (e.g. imgs[..., 0]) for other channel counts")
        # [N, H, W, 1] or [N, 1, H, W] -> single channel
        imgs = imgs[..., 0] if imgs.shape[-1] == 1 else imgs[:, 0]
    n, h, w = imgs.shape[:3]
    chan = imgs.shape[3:]  # () or (C,)
    ncol = nrow
    nrows = -(-n // ncol)
    canvas = np.full(
        (padding + nrows * (h + padding), padding + ncol * (w + padding)) + chan,
        pad_value, imgs.dtype)
    for k in range(n):
        r, c = divmod(k, ncol)
        canvas[padding + r * (h + padding): padding + r * (h + padding) + h,
               padding + c * (w + padding): padding + c * (w + padding) + w] = imgs[k]
    return canvas


def plot_img_grid(imgdata, d: int, **kwargs) -> None:
    """d x d grid of decoded 2-D images (reference: ``utils/viz.py:7-29``)."""
    import matplotlib.pyplot as plt
    imgs = as_numpy(imgdata)
    if imgs.ndim < 3:
        raise AssertionError("Images must be passed as a 3D or 4D tensor")
    grid = make_img_grid(imgs, d, kwargs.get("padding", 2), kwargs.get("pad_value", 0))
    plt.figure(figsize=(8, 8))
    plt.imshow(grid, cmap=kwargs.get("cmap", "gnuplot"),
               origin=kwargs.get("origin", "upper"),
               extent=kwargs.get("extent"))
    plt.xticks(fontsize=14)
    plt.yticks(fontsize=14)
    plt.xlabel("$z_1$", fontsize=18)
    plt.ylabel("$z_2$", fontsize=18)
    plt.show()


def plot_spect_grid(spectra, d: int, **kwargs) -> None:
    """d x d grid of 1-D spectral plots (reference: ``utils/viz.py:32-45``)."""
    import matplotlib.pyplot as plt
    spectra = as_numpy(spectra)
    _, axes = plt.subplots(d, d, figsize=(8, 8),
                           subplot_kw={"xticks": [], "yticks": []},
                           gridspec_kw=dict(hspace=0.1, wspace=0.1))
    ylim = kwargs.get("ylim")
    for ax, y in zip(np.ravel(axes), spectra):
        ax.plot(y.squeeze())
        if ylim:
            ax.set_ylim(*ylim)
    plt.show()


def plot_grid_traversal(imgdata, d: int, data_dim: Sequence[int], disc_dim: int,
                        **kwargs) -> None:
    """disc_dim x d image strip for joint latent traversals
    (reference: ``utils/viz.py:48-74``)."""
    import matplotlib.pyplot as plt
    imgs = as_numpy(imgdata)
    if imgs.ndim < 3:
        raise AssertionError("Images must be passed as a 3D or 4D tensor")
    padding = kwargs.get("padding", 2)
    grid = make_img_grid(imgs, d, padding, kwargs.get("pad_value", 0))
    grid = grid[: (data_dim[0] + padding) * disc_dim]
    plt.figure(figsize=(8, 8))
    plt.imshow(grid, cmap=kwargs.get("cmap", "gnuplot"),
               origin=kwargs.get("origin", "upper"),
               extent=kwargs.get("extent"))
    plt.xlabel("$z_{cont}$", fontsize=18)
    plt.ylabel("$z_{disc}$", fontsize=18)
    plt.xticks([])
    plt.yticks([])
    plt.show()


def plot_latent_predictions(predictions, d: int, **kwargs) -> None:
    """Heatmap of GP predictions over the latent grid
    (reference inline plotting in ``models/ivae.py:345-360``)."""
    import matplotlib.pyplot as plt
    preds = as_numpy(predictions).reshape(d, d)
    plt.figure(figsize=(8, 8))
    heatmap = plt.imshow(preds, cmap=kwargs.get("cmap", "viridis"), aspect="auto")
    plt.colorbar(heatmap, label="Prediction Value")
    plt.xlabel("$z_1$", fontsize=14)
    plt.ylabel("$z_2$", fontsize=14)
    plt.title("Predictions Visualization")
    plt.show()
