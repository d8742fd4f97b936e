"""The port's visualization (`dvg_tpu_torch.utils.viz`) and its PIL-free
codecs against `dvg_tpu.utils.viz`: grids and borders equal; the port's PNG,
decoded by imageio, equal to `dvg_tpu`'s PNG decoded; GIF frames decoded
by imageio equal to the composed frames when a frame has ≤ 256 colours and
within the quantizer's bound otherwise; captioned frames equal to
`dvg_tpu`'s outside both packages' caption rectangles (the port draws its
own 5×7 bitmap font)."""

import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import ImageDraw, ImageFont

from dvg_tpu.utils import viz as jviz
from dvg_tpu_torch.utils import _codecs, viz


def frames(seed, n, h=20, w=16, c=3, levels=None):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, h, w, c).astype(np.float32)
    if levels:
        x = np.round(x * (levels - 1)) / (levels - 1)
    return x


def test_image_grid_and_add_border_equal():
    a, b = frames(0, 3), frames(1, 2, c=1)
    grids = [list(a), [list(a), list(a)], a, [list(b), list(a[:2])],
             b[0][..., 0], [[a[0]], [b[1], a[1], a[2]]]]
    for g in grids:
        for pad in (0, 1, 3):
            np.testing.assert_array_equal(viz.image_grid(g, padding=pad),
                                          jviz.image_grid(g, padding=pad))
    for img in (a[0], b[0], b[0][..., 0]):
        for color in ("red", "green", "black"):
            np.testing.assert_array_equal(viz.add_border(img, color),
                                          jviz.add_border(img, color))


def test_save_image_decodes_equal(tmp_path):
    grid = [list(frames(2, 3)), list(frames(3, 3, c=1))]
    viz.save_image(str(tmp_path / "port" / "g.png"), grid)
    jviz.save_image(str(tmp_path / "jax.png"), grid)
    got = imageio.imread(tmp_path / "port" / "g.png")
    want = imageio.imread(tmp_path / "jax.png")
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("levels", [4, None], ids=["few_colours",
                                                   "many_colours"])
def test_gif_frames_decode_to_composed(tmp_path, levels):
    seq = [[list(f)] for f in frames(4, 5 * 3, levels=levels).reshape(
        5, 3, 20, 16, 3)]
    path = str(tmp_path / "a.gif")
    viz.save_gif(path, seq, duration=0.25)
    composed = [viz._to_uint8(viz.image_grid(f, padding=0)) for f in seq]
    decoded = imageio.mimread(path)
    assert len(decoded) == len(composed)
    for want, got in zip(composed, decoded):
        got = np.asarray(got)[..., :3]
        _, _, bound = _codecs.quantize(want)
        n_colours = len(np.unique(want.reshape(-1, 3), axis=0))
        assert (bound == 0) == (n_colours <= 256)
        err = np.abs(got.astype(int) - want.astype(int)).max()
        assert err <= bound, (err, bound)
        assert (bound > 0) == (levels is None)
    # the frames of dvg_tpu's GIF are the same composition
    held = []
    real = imageio.mimsave
    imageio.mimsave = lambda p, fs, **kw: held.extend(fs)
    try:
        jviz.save_gif(str(tmp_path / "j.gif"), seq, duration=0.25)
    finally:
        imageio.mimsave = real
    for want, got in zip(held, composed):
        np.testing.assert_array_equal(got, want)


def caption_mask(h, w, text, jax_side):
    """Where either package may draw `text` on an (h, w) tile: Pillow's
    default-font box for dvg_tpu, the 5×7 font's box for the port, each
    grown by a pixel."""
    mask = np.zeros((h, w), bool)
    x0, y0 = 4, h - 32
    lines = text.split("\n")
    mask[y0 - 1:y0 + viz.LINE * len(lines) + 1,
         x0 - 1:x0 + viz.ADVANCE * max(map(len, lines)) + 1] = True
    if jax_side:
        from PIL import Image
        d = ImageDraw.Draw(Image.new("RGB", (w, h)))
        l, t, r, b = d.textbbox((x0, y0), text, font=ImageFont.load_default())
        mask[max(t - 1, 0):b + 1, max(l - 1, 0):r + 1] = True
    return mask


def test_captioned_frames_equal_outside_captions(tmp_path):
    texts = ["Ground\ntruth", "Approx.\nposterior", "Best SSIM",
             "Random\nsample 1"]
    gifs = [[viz.add_border(f, "red" if t else "green")
             for f in frames(10 + t, 4, h=64, w=64, c=1)] for t in range(3)]
    txts = [texts] * 3
    held = []
    real = imageio.mimsave
    imageio.mimsave = lambda p, fs, **kw: held.extend(fs)
    try:
        jviz.save_gif_with_text(str(tmp_path / "j.gif"), gifs, txts)
    finally:
        imageio.mimsave = real
    port = viz.text_frames(gifs, txts)
    tile_h, tile_w = gifs[0][0].shape[:2]
    mask = np.concatenate([caption_mask(tile_h, tile_w, t, True)
                           for t in texts], axis=1)
    for fi, (got, want) in enumerate(zip(port, held)):
        assert got.shape == want.shape and got.dtype == np.uint8
        np.testing.assert_array_equal(got[~mask], want[~mask])
        # the port's captions are drawn: black pixels in each rectangle
        for k, t in enumerate(texts):
            own = caption_mask(tile_h, tile_w, t, False)
            tile = got[:, k * tile_w:(k + 1) * tile_w]
            blank = np.uint8(viz.image_grid(gifs[fi][k]) * 255)
            assert (tile[own] != blank[own]).any()
    viz.save_gif_with_text(str(tmp_path / "p.gif"), gifs, txts)
    for got, want in zip(imageio.mimread(tmp_path / "p.gif"), port):
        _, _, bound = _codecs.quantize(want)
        assert np.abs(np.asarray(got)[..., :3].astype(int)
                      - want.astype(int)).max() <= bound


def test_font_covers_captions_and_boxes_unknown_characters():
    for ch in "Ground truthApprox.posteriorBest SSIMRandom sample 0123456789":
        assert viz._FONT_CHARS.find(ch) >= 0, ch
    assert viz._glyph("A").shape == (viz.GLYPH_H, viz.GLYPH_W)
    assert viz._glyph("A").any() and not viz._glyph(" ").any()
    np.testing.assert_array_equal(viz._glyph("é"), viz._MISSING)
