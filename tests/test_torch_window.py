"""The PyTorch port's preview backends, headless (the cases of
``tests/test_window.py:36-80`` on ``reforge_tpu_torch/window.py``):
PygameWindow under SDL's dummy video driver, the kitty protocol's bytes
against the JAX package's KittyPreview, and create_preview's choice."""

import contextlib
import io

import numpy as np
import pytest

from reforge_tpu import window as jwindow
from reforge_tpu_torch import window


@pytest.fixture()
def pygame(monkeypatch):
    pygame = pytest.importorskip("pygame")
    monkeypatch.setenv("SDL_VIDEODRIVER", "dummy")
    yield pygame
    if pygame.display.get_init():
        pygame.display.quit()


def frame(h=48, w=64, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 4), np.uint8)


def test_show_and_close(pygame):
    win = window.PygameWindow(64, 48)
    assert win.interactive
    win.show(frame())
    assert win.target_px() == 64  # max(screen w, h)
    win.close()
    assert not pygame.display.get_init()


def test_show_aspect_fit_scales(pygame):
    """Frames of another aspect than the window: the smoothscale and
    centred-blit path (command.rs:111-123)."""
    win = window.PygameWindow(64, 48)
    win.show(frame(h=100, w=30))
    win.show(frame(h=10, w=300))
    win.close()


def test_poll_quit_on_quit_event(pygame):
    win = window.PygameWindow(64, 48)
    assert win.poll_quit() is False
    pygame.event.post(pygame.event.Event(pygame.QUIT))
    assert win.poll_quit() is True
    win.close()


def test_poll_quit_on_escape(pygame):
    win = window.PygameWindow(64, 48)
    pygame.event.post(pygame.event.Event(pygame.KEYDOWN, key=pygame.K_ESCAPE))
    assert win.poll_quit() is True
    pygame.event.post(pygame.event.Event(pygame.KEYDOWN, key=pygame.K_a))
    assert win.poll_quit() is False  # other keys do not quit
    win.close()


def test_poll_resize_roundtrip(pygame):
    win = window.PygameWindow(64, 48)
    assert win.poll_resize() is None
    pygame.event.post(pygame.event.Event(pygame.VIDEORESIZE, w=128, h=96))
    assert win.poll_quit() is False  # a resize is not a quit
    assert win.poll_resize() == (128, 96)
    assert win.poll_resize() is None  # consumed
    win.close()


@pytest.mark.parametrize("shape,max_px", [((8, 10), 64), ((12, 40), 16), ((540, 960), 960),
                                          ((1, 1), 960), ((100, 3000), 960)])
def test_kitty_bytes_equal_the_reference(shape, max_px):
    """Two frames (the second overdraws from the cursor's home) written
    byte for byte as the JAX package's KittyPreview writes them, payloads
    of one chunk and of many, and the strided fallback past max_px."""
    outs = []
    for backend in (window, jwindow):
        kp = backend.KittyPreview(max_cols_px=max_px)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            kp.show(frame(*shape, seed=3))
            kp.show(frame(*shape, seed=4))
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert outs[0].startswith("\x1b_Ga=T,f=32,") and "\x1b[H" in outs[0]


def test_kitty_strided_fallback(capsys):
    kp = window.KittyPreview(max_cols_px=16)
    assert kp.target_px() == 16
    kp.show(frame(h=12, w=40))
    assert "s=14" in capsys.readouterr().out  # stride ceil(40 / 16) = 3 -> 14 columns


@pytest.mark.parametrize("kind,env,want", [
    ("none", {}, window.NullPreview),
    ("kitty", {}, window.KittyPreview),
    ("auto", {"TERM": "xterm-kitty"}, window.KittyPreview),
    ("auto", {"TERM": "xterm"}, window.NullPreview),
])
def test_create_preview(kind, env, want, monkeypatch):
    for var in ("DISPLAY", "WAYLAND_DISPLAY"):
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    assert type(window.create_preview(kind, 64, 48)) is want
