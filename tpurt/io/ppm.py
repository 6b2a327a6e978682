"""Binary PPM (P6) writer/reader (SURVEY.md §1 L10, Appendix A.9).

Byte format fixed by decree: header ``P6\\n{W} {H}\\n255\\n`` then rows
top-to-bottom, RGB interleaved uint8. cpu_ref and the device renderer share
this writer, so files are byte-identical when the tonemapped pixels agree.
"""

from __future__ import annotations

import numpy as np


def write(path: str, rgb8: np.ndarray) -> None:
    rgb8 = np.asarray(rgb8, np.uint8)
    assert rgb8.ndim == 3 and rgb8.shape[2] == 3, rgb8.shape
    h, w, _ = rgb8.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode("ascii"))
        f.write(rgb8.tobytes())


def read(path: str) -> np.ndarray:
    """Reads the P6 subset this project writes (used by golden tests)."""
    with open(path, "rb") as f:
        data = f.read()
    # header: magic, dims, maxval separated by single whitespace (our writer)
    parts = data.split(b"\n", 3)
    assert parts[0] == b"P6", "not a P6 PPM"
    w, h = (int(x) for x in parts[1].split())
    assert parts[2] == b"255"
    pix = np.frombuffer(parts[3], np.uint8, count=w * h * 3)
    return pix.reshape(h, w, 3)
