"""The native baseline JPEG encoder (lvba_jpeg_encode, io/image.encode_jpeg)
against cv2.imwrite(".jpg") on the CPU: byte for byte at cv2's defaults
(quality 95, 4:2:0, JFIF, the Annex K Huffman tables) on random and smooth
images at sizes a multiple of the 16-pixel MCU and not, one image at a
time and a stack on the host's threads; a stream past the first pass's
room; the frame header it writes; shapes
it refuses."""

import cv2
import numpy as np
import pytest

from global_lvba_tpu_torch.io import image as gi

SIZES = [(16, 16), (7, 5), (17, 33), (24, 40), (128, 160), (96, 130),
         (512, 640)]


def _img(h, w, kind, seed):
    if kind == "random":
        return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                    np.uint8)
    y, x = np.mgrid[0:h, 0:w]
    return np.stack([(x * 3 + y) % 256, (y * 2) % 256, ((x + y) * 5) % 256],
                    -1).astype(np.uint8)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("kind", ["random", "smooth"])
def test_bytes_equal_cv2(size, kind):
    img = _img(*size, kind, size[0] * size[1])
    want = cv2.imencode(".jpg", img)[1].tobytes()
    assert gi.encode_jpeg(img)[0] == want


def test_stack_on_threads_equals_single_images(tmp_path):
    imgs = np.stack([_img(64, 80, "random", k) for k in range(7)])
    imgs[3] = _img(64, 80, "smooth", 0)
    many = gi.encode_jpeg(imgs)
    assert len(many) == 7
    for k in range(7):
        assert many[k] == gi.encode_jpeg(imgs[k])[0]
        assert many[k] == cv2.imencode(".jpg", imgs[k])[1].tobytes()
    p, q = tmp_path / "p.jpg", tmp_path / "q.jpg"
    gi.imwrite_jpeg(p, imgs[0])
    cv2.imwrite(str(q), imgs[0])
    assert p.read_bytes() == q.read_bytes()


def test_frame_header_and_decode():
    y, x = np.mgrid[0:40, 0:56]
    img = np.stack([x * 4, y * 6, (x + y) * 2], -1).astype(np.uint8)
    data = gi.encode_jpeg(img)[0]
    assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
    assert data[6:11] == b"JFIF\x00"
    k = data.index(b"\xff\xc0")              # SOF0: baseline
    assert data[k + 5:k + 9] == bytes([0, 40, 0, 56])
    assert data[k + 10:k + 19] == bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])
    back = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    assert back.shape == img.shape
    assert np.abs(back.astype(int) - img).mean() < 3


def test_a_stream_past_the_first_buffer_is_encoded_again(monkeypatch):
    """An image whose stream overflows the first pass's room comes back
    whole from the second pass."""
    imgs = np.stack([_img(96, 128, "random", k) for k in range(3)])
    assert gi._jpeg_batch(imgs, 600) == [None] * 3
    monkeypatch.setattr(gi, "JPEG_FIRST_BYTES_A_PIXEL", 0.05)
    got = gi.encode_jpeg(imgs)
    for k in range(3):
        assert got[k] == cv2.imencode(".jpg", imgs[k])[1].tobytes()


def test_rejects_other_shapes():
    with pytest.raises(ValueError):
        gi.encode_jpeg(np.zeros((8, 8), np.uint8))
    with pytest.raises(ValueError):
        gi.encode_jpeg(np.zeros((2, 8, 8, 4), np.uint8))
