"""Writes the glyph table of tscd_torch/csrc/host/draw.cpp (between its
`glyph table` markers) from the installed cv2.

OpenCV 5 draws `cv2.putText(..., FONT_HERSHEY_SIMPLEX, 0.4, color, 1)` with
a built-in TrueType font, antialiased, not with Hershey strokes. Measured
against cv2 5.0.0 (tests/test_torch_port_draw.py holds the result to it):
at this scale and thickness each character is one fixed 8-bit coverage
bitmap placed at a whole-pixel pen position, the pen advancing by the
character's whole-pixel advance (`cv2.getTextSize` of the string is the sum
of the advances plus 1, by 11, its baseline the largest of the characters'),
and the characters are blended one after another, each pixel
`(color * a + pixel * (255 - a) + 127) // 255`. So the table holds, for each
printable ASCII character, what cv2 draws when it writes that character
alone in white on black at a known origin: the coverage bitmap's box
relative to the origin, and the advance and baseline `cv2.getTextSize`
gives.

    python tests/torch_port_glyphs.py
"""

import os
import re

import cv2
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRAW = os.path.join(REPO, "tscd_torch", "csrc", "host", "draw.cpp")
FONT, SCALE, THICK = cv2.FONT_HERSHEY_SIMPLEX, 0.4, 1
OX, OY = 40, 60  # origin on a 120 x 100 canvas: far from every edge


def glyph(c):
    img = np.zeros((100, 120, 3), np.uint8)
    cv2.putText(img, c, (OX, OY), FONT, SCALE, (255, 255, 255), THICK)
    a = img[..., 0]
    assert (img[..., 1] == a).all() and (img[..., 2] == a).all()
    (w, h), base = cv2.getTextSize(c, FONT, SCALE, THICK)
    assert h == 11
    ys, xs = np.nonzero(a)
    if len(ys) == 0:
        return (w - THICK, 0, 0, 0, 0, base), b""
    y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
    assert 0 < x0 and x1 < a.shape[1] and 0 < y0 and y1 < a.shape[0]
    return (w - THICK, int(x0 - OX), int(y0 - OY), int(x1 - x0), int(y1 - y0), base), \
        a[y0:y1, x0:x1].tobytes()


def main():
    rows, data = [], b""
    for code in range(32, 127):
        (adv, x, y, w, h, base), bits = glyph(chr(code))
        rows.append(f"    {{{adv}, {x}, {y}, {w}, {h}, {base}, {len(data)}}},  // {chr(code)!r}")
        data += bits
    body = ["// glyph table (tests/torch_port_glyphs.py, cv2 " + cv2.__version__ + ")",
            "const Glyph kGlyphs[95] = {", *rows, "};",
            f"const uint8_t kCoverage[{len(data)}] = {{"]
    vals = [str(b) for b in data]
    for i in range(0, len(vals), 24):
        body.append("    " + ", ".join(vals[i:i + 24]) + ",")
    body += ["};", "// end of glyph table"]
    src = open(DRAW).read()
    src, n = re.subn(r"// glyph table \(.*?// end of glyph table", "\n".join(body), src,
                     flags=re.S)
    assert n == 1, "draw.cpp lacks the glyph table's markers"
    with open(DRAW, "w") as f:
        f.write(src)
    print(f"wrote {DRAW}: 95 glyphs, {len(data)} coverage bytes")


if __name__ == "__main__":
    main()
