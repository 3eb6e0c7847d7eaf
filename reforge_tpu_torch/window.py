"""Preview backends: live output display (the port's copy of
``reforge_tpu/window.py``).

The reference previews via a winit window + Vulkan swapchain with
aspect-fit centered blit (reference: src/vulkan/swapchain.rs,
src/vulkan/command.rs:97-141).  Here a preview backend consumes host RGBA
frames; three implementations:

  * ``PygameWindow``  — an SDL window (interactive preview; Esc/close quits,
    matching main.rs:186-219).
  * ``NullPreview``   — headless no-op (benchmark loops, CI).
  * ``KittyPreview``  — draws frames inline in terminals implementing the
    kitty graphics protocol; a zero-dependency remote-friendly preview.
"""

from __future__ import annotations

import base64
import os
import sys
import zlib

import numpy as np

from .utils import warnln


class PreviewBackend:
    interactive = False

    def show(self, rgba: np.ndarray) -> None:  # (H, W, 4) uint8
        raise NotImplementedError

    def target_px(self) -> "int | None":
        """Largest edge this backend will actually display, or None for
        full resolution.  The engine downsamples ON DEVICE to this bound
        before fetching (engine.read_output_scaled), so only the
        displayed pixels cross the device->host link."""
        return None

    def poll_quit(self) -> bool:
        """True when the user asked to close (Esc / window close)."""
        return False

    def poll_resize(self) -> "tuple[int, int] | None":
        """New (width, height) if the window was resized since last poll.

        The reference rebuilds the swapchain on resize, and when no input
        image pins the extent the window size becomes the new graph size
        (render.rs:500-505, 529-532); the CLI loop mirrors that.
        """
        return None

    def close(self) -> None:
        pass


class NullPreview(PreviewBackend):
    def show(self, rgba: np.ndarray) -> None:
        pass


class PygameWindow(PreviewBackend):
    interactive = True

    def __init__(self, width: int, height: int, title: str = "reforge-tpu"):
        os.environ.setdefault("PYGAME_HIDE_SUPPORT_PROMPT", "1")
        import pygame

        self._pygame = pygame
        self._resized = None
        pygame.display.init()
        self._screen = pygame.display.set_mode((width, height), pygame.RESIZABLE)
        pygame.display.set_caption(title)

    def show(self, rgba: np.ndarray) -> None:
        pygame = self._pygame
        h, w = rgba.shape[:2]
        surf = pygame.image.frombuffer(
            np.ascontiguousarray(rgba[:, :, :3]).tobytes(), (w, h), "RGB"
        )
        sw, sh = self._screen.get_size()
        # Aspect-fit centering, the reference's blit_copy behavior
        # (command.rs:111-123).
        scale = min(sw / w, sh / h)
        dw, dh = max(1, int(w * scale)), max(1, int(h * scale))
        if (dw, dh) != (w, h):
            surf = pygame.transform.smoothscale(surf, (dw, dh))
        self._screen.fill((0, 0, 0))
        self._screen.blit(surf, ((sw - dw) // 2, (sh - dh) // 2))
        pygame.display.flip()

    def target_px(self):
        sw, sh = self._screen.get_size()
        return max(sw, sh)

    def poll_quit(self) -> bool:
        pygame = self._pygame
        for event in pygame.event.get():
            if event.type == pygame.QUIT:
                return True
            if event.type == pygame.KEYDOWN and event.key == pygame.K_ESCAPE:
                return True
            if event.type == pygame.VIDEORESIZE:
                self._resized = (event.w, event.h)
        return False

    def poll_resize(self):
        r = self._resized
        self._resized = None
        return r

    def close(self) -> None:
        self._pygame.display.quit()


class KittyPreview(PreviewBackend):
    """Inline terminal preview via the kitty graphics protocol."""

    def __init__(self, max_cols_px: int = 960):
        self.max_px = max_cols_px
        self._first = True

    def target_px(self):
        return self.max_px

    def show(self, rgba: np.ndarray) -> None:
        h, w = rgba.shape[:2]
        if w > self.max_px:
            # Normally never taken: the engine already box-downsamples ON
            # DEVICE to target_px() in linear light before the fetch
            # (engine.read_output_scaled).  Direct callers get a cheap
            # strided fallback, capped so the result is never empty.
            step = min((w + self.max_px - 1) // self.max_px, h, w)
            rgba = rgba[::step, ::step]
            h, w = rgba.shape[:2]
        payload = zlib.compress(np.ascontiguousarray(rgba).tobytes(), 1)
        b64 = base64.standard_b64encode(payload)
        out = sys.stdout
        # Move cursor home so successive frames overdraw in place.
        if not self._first:
            out.write("\x1b[H")
        self._first = False
        # Chunks by offset: slicing the rest off each time would copy it
        # once a chunk, quadratic in the payload.
        text = b64.decode()
        for start in range(0, len(text), 4096):
            chunk = text[start:start + 4096]
            more = 1 if start + 4096 < len(text) else 0
            if start == 0:
                out.write(f"\x1b_Ga=T,f=32,s={w},v={h},o=z,m={more};{chunk}\x1b\\")
            else:
                out.write(f"\x1b_Gm={more};{chunk}\x1b\\")
        out.write("\n")
        out.flush()


def create_preview(kind: str, width: int, height: int) -> PreviewBackend:
    """kind: auto | window | kitty | none."""
    if kind == "none":
        return NullPreview()
    if kind == "kitty":
        return KittyPreview()
    if kind == "window":
        return PygameWindow(width, height)
    # auto: a real window needs a display server.
    if os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY"):
        try:
            return PygameWindow(width, height)
        except Exception as e:
            warnln(f"Window preview unavailable ({e}); running without preview")
    if os.environ.get("TERM", "").startswith("xterm-kitty"):
        return KittyPreview()
    return NullPreview()
