"""Writes the JPEG fixtures of this folder: frames Pillow cannot write,
made by libjpeg through ``tests/_torch_port_jpeg_helper.py`` from seeded
pictures at quality 90: one 160×120 picture (smooth bands with a noise
patch) in each kind, and two 640×480 ones in 4:1:1 (smooth bands, and
smooth bands with noise over the middle half of each side).

    python tests/torch_port_jpegs/make_fixtures.py

needs g++ and libjpeg's headers (``jpeglib.h``), which the machine with the
card lacks: the files are committed, and the tests read them there.
"""

import pathlib
import sys
import tempfile

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

import _torch_port_jpeg_helper as jh  # noqa: E402

# name: the picture, and the helper's options (the luma's sampling
# factors, coding, scans)
FIXTURES = {
    "arith_sequential_420.jpg": ("small", dict(samp=(2, 2), arith=True)),
    "arith_progressive_420.jpg": ("small", dict(samp=(2, 2), arith=True,
                                                progressive=True, restart=5)),
    "multiscan_sequential_422.jpg": ("small", dict(samp=(2, 1), scans=1)),
    "rgb_transform_444.jpg": ("small", dict(samp=(1, 1), rgb=True)),
    "sampling_411.jpg": ("small", dict(samp=(4, 1))),
    "sampling_411_smooth_640x480.jpg": ("smooth", dict(samp=(4, 1))),
    "sampling_411_noise_640x480.jpg": ("noise", dict(samp=(4, 1))),
}


def picture(w: int = 160, h: int = 120, seed: int = 27) -> np.ndarray:
    """Three phase-shifted sinusoids, a noise patch in the middle."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    a = np.stack([127.5 + 120 * np.sin(xx / (13 + 5 * c) + yy / (17 + 3 * c)
                                       + c) for c in range(3)], -1)
    a[h // 4:3 * h // 4, w // 4:3 * w // 4] = rng.randint(
        0, 256, (h // 2, w // 2, 3))
    return a.astype(np.uint8)


def large(noise: bool, w: int = 640, h: int = 480,
          seed: int = 27) -> np.ndarray:
    """Three sinusoids of other phases and periods (R and B differ
    everywhere), with uniform noise over the middle half of each side
    where ``noise``."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    ph = rng.uniform(0, 2 * np.pi, 3)
    a = np.stack([127.5 + 120 * np.sin(xx / (23 + 9 * c) + yy / (31 + 7 * c)
                                       + ph[c]) for c in range(3)], -1)
    if noise:
        a[h // 4:3 * h // 4, w // 4:3 * w // 4] = rng.randint(
            0, 256, (h // 2, w // 2, 3))
    return a.astype(np.uint8)


def main() -> None:
    with tempfile.TemporaryDirectory() as tmp:
        lib = jh.build(pathlib.Path(tmp))
        pictures = {"small": picture(), "smooth": large(False),
                    "noise": large(True)}
        for name, (pic, kw) in FIXTURES.items():
            jh.write(lib, pictures[pic], HERE / name, quality=90, **kw)
            print(name, (HERE / name).stat().st_size, "bytes")


if __name__ == "__main__":
    main()
