"""Bitmap text rendering for annotations.

Replaces the reference's freetype GL text layer
(gl/compv_gl_freetype.cxx + drawing text canvas) for a headless
host: a hand-authored 5x7 pixel font rasterized straight into the RGB
canvas. No external font files, no GL — labels on dumped PNG/video
artifacts is the product need, not typography.

The glyphs below are original '#'-grid art (clean-room, not a copied font
table); lowercase maps to uppercase, unknown characters render as a
hollow box.
"""
from __future__ import annotations

import numpy as np

__all__ = ["draw_text", "text_size", "FONT_H", "FONT_W"]

FONT_W, FONT_H = 5, 7

_GLYPHS = {
    " ": ["     "] * 7,
    "0": [" ### ", "#   #", "#  ##", "# # #", "##  #", "#   #", " ### "],
    "1": ["  #  ", " ##  ", "  #  ", "  #  ", "  #  ", "  #  ", " ### "],
    "2": [" ### ", "#   #", "    #", "   # ", "  #  ", " #   ", "#####"],
    "3": [" ### ", "#   #", "    #", "  ## ", "    #", "#   #", " ### "],
    "4": ["   # ", "  ## ", " # # ", "#  # ", "#####", "   # ", "   # "],
    "5": ["#####", "#    ", "#### ", "    #", "    #", "#   #", " ### "],
    "6": [" ### ", "#    ", "#    ", "#### ", "#   #", "#   #", " ### "],
    "7": ["#####", "    #", "   # ", "  #  ", " #   ", " #   ", " #   "],
    "8": [" ### ", "#   #", "#   #", " ### ", "#   #", "#   #", " ### "],
    "9": [" ### ", "#   #", "#   #", " ####", "    #", "    #", " ### "],
    "A": [" ### ", "#   #", "#   #", "#####", "#   #", "#   #", "#   #"],
    "B": ["#### ", "#   #", "#   #", "#### ", "#   #", "#   #", "#### "],
    "C": [" ### ", "#   #", "#    ", "#    ", "#    ", "#   #", " ### "],
    "D": ["#### ", "#   #", "#   #", "#   #", "#   #", "#   #", "#### "],
    "E": ["#####", "#    ", "#    ", "#### ", "#    ", "#    ", "#####"],
    "F": ["#####", "#    ", "#    ", "#### ", "#    ", "#    ", "#    "],
    "G": [" ### ", "#   #", "#    ", "# ###", "#   #", "#   #", " ### "],
    "H": ["#   #", "#   #", "#   #", "#####", "#   #", "#   #", "#   #"],
    "I": [" ### ", "  #  ", "  #  ", "  #  ", "  #  ", "  #  ", " ### "],
    "J": ["    #", "    #", "    #", "    #", "#   #", "#   #", " ### "],
    "K": ["#   #", "#  # ", "# #  ", "##   ", "# #  ", "#  # ", "#   #"],
    "L": ["#    ", "#    ", "#    ", "#    ", "#    ", "#    ", "#####"],
    "M": ["#   #", "## ##", "# # #", "# # #", "#   #", "#   #", "#   #"],
    "N": ["#   #", "##  #", "# # #", "#  ##", "#   #", "#   #", "#   #"],
    "O": [" ### ", "#   #", "#   #", "#   #", "#   #", "#   #", " ### "],
    "P": ["#### ", "#   #", "#   #", "#### ", "#    ", "#    ", "#    "],
    "Q": [" ### ", "#   #", "#   #", "#   #", "# # #", "#  # ", " ## #"],
    "R": ["#### ", "#   #", "#   #", "#### ", "# #  ", "#  # ", "#   #"],
    "S": [" ####", "#    ", "#    ", " ### ", "    #", "    #", "#### "],
    "T": ["#####", "  #  ", "  #  ", "  #  ", "  #  ", "  #  ", "  #  "],
    "U": ["#   #", "#   #", "#   #", "#   #", "#   #", "#   #", " ### "],
    "V": ["#   #", "#   #", "#   #", "#   #", " # # ", " # # ", "  #  "],
    "W": ["#   #", "#   #", "#   #", "# # #", "# # #", "## ##", "#   #"],
    "X": ["#   #", " # # ", "  #  ", "  #  ", "  #  ", " # # ", "#   #"],
    "Y": ["#   #", " # # ", "  #  ", "  #  ", "  #  ", "  #  ", "  #  "],
    "Z": ["#####", "    #", "   # ", "  #  ", " #   ", "#    ", "#####"],
    ".": ["     ", "     ", "     ", "     ", "     ", " ##  ", " ##  "],
    ",": ["     ", "     ", "     ", "     ", " ##  ", "  #  ", " #   "],
    ":": ["     ", " ##  ", " ##  ", "     ", " ##  ", " ##  ", "     "],
    ";": ["     ", " ##  ", " ##  ", "     ", " ##  ", "  #  ", " #   "],
    "-": ["     ", "     ", "     ", "#####", "     ", "     ", "     "],
    "+": ["     ", "  #  ", "  #  ", "#####", "  #  ", "  #  ", "     "],
    "/": ["    #", "    #", "   # ", "  #  ", " #   ", "#    ", "#    "],
    "(": ["   # ", "  #  ", " #   ", " #   ", " #   ", "  #  ", "   # "],
    ")": [" #   ", "  #  ", "   # ", "   # ", "   # ", "  #  ", " #   "],
    "%": ["##  #", "##  #", "   # ", "  #  ", " #   ", "#  ##", "#  ##"],
    "=": ["     ", "     ", "#####", "     ", "#####", "     ", "     "],
    "_": ["     ", "     ", "     ", "     ", "     ", "     ", "#####"],
    "'": ["  #  ", "  #  ", "     ", "     ", "     ", "     ", "     "],
    "!": ["  #  ", "  #  ", "  #  ", "  #  ", "  #  ", "     ", "  #  "],
    "?": [" ### ", "#   #", "    #", "   # ", "  #  ", "     ", "  #  "],
    "<": ["   # ", "  #  ", " #   ", "#    ", " #   ", "  #  ", "   # "],
    ">": [" #   ", "  #  ", "   # ", "    #", "   # ", "  #  ", " #   "],
    "[": [" ##  ", " #   ", " #   ", " #   ", " #   ", " #   ", " ##  "],
    "]": ["  ## ", "   # ", "   # ", "   # ", "   # ", "   # ", "  ## "],
    "*": ["     ", "# # #", " ### ", "#####", " ### ", "# # #", "     "],
    "#": [" # # ", "#####", " # # ", " # # ", " # # ", "#####", " # # "],
    "x": ["     ", "     ", "#   #", " # # ", "  #  ", " # # ", "#   #"],
}
_UNKNOWN = ["#####", "#   #", "#   #", "#   #", "#   #", "#   #", "#####"]


def _glyph_mask(ch: str) -> np.ndarray:
    rows = _GLYPHS.get(ch) or _GLYPHS.get(ch.upper()) or _UNKNOWN
    return np.array([[c == "#" for c in r] for r in rows], bool)


# cache masks per character (tiny)
_CACHE: dict = {}


def text_size(text: str, scale: int = 1) -> tuple:
    """(height, width) in pixels of the rendered string."""
    return FONT_H * scale, max(0, len(text) * (FONT_W + 1) * scale - scale)


def draw_text(canvas: np.ndarray, x: int, y: int, text: str,
              color=(255, 255, 255), scale: int = 1,
              background=None) -> np.ndarray:
    """Rasterize ``text`` with its top-left corner at (x, y), in place.

    ``background`` (optional RGB) fills the text's bounding box first —
    keeps labels legible over busy imagery, like the reference's filled
    text quads."""
    h, w = canvas.shape[:2]
    th, tw = text_size(text, scale)
    if background is not None:
        y0, y1 = max(0, y - scale), min(h, y + th + scale)
        x0, x1 = max(0, x - scale), min(w, x + tw + scale)
        if y1 > y0 and x1 > x0:
            canvas[y0:y1, x0:x1] = background
    cx = x
    for ch in text:
        m = _CACHE.get(ch)
        if m is None:
            m = _CACHE[ch] = _glyph_mask(ch)
        if scale != 1:
            m2 = np.kron(m, np.ones((scale, scale), bool))
        else:
            m2 = m
        gh, gw = m2.shape
        # clip to canvas
        sy, sx = max(0, -y), max(0, -cx)
        ey = min(gh, h - y)
        ex = min(gw, w - cx)
        if ey > sy and ex > sx:
            sub = canvas[y + sy: y + ey, cx + sx: cx + ex]
            sub[m2[sy:ey, sx:ex]] = color
        cx += (FONT_W + 1) * scale
    return canvas
