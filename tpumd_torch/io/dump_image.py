"""dump image and dump movie: snapshots rendered to PPM images.

The port of tpumd/io/dump_image.py (the core of src/dump_image.cpp and
src/image.cpp): an orthographic camera at (theta, phi), spheres drawn back
to front into a z-buffer with Lambert and specular shading, coloured by
type in the reference's colour rotation.  The output is binary PPM (P6),
the one format that needs no image library; dump movie appends every
frame to one P6 stream (the bytes the reference pipes into ffmpeg).  The
positions are read to the host at the dump's steps and drawn there.
"""

from __future__ import annotations

import math
import os

import numpy as np

from tpumd_torch.io.dump import Dump

# dump_image.cpp:1530 default color rotation for "type" coloring
_TYPE_COLORS = [
    (1.0, 0.0, 0.0),      # red
    (0.0, 1.0, 0.0),      # green
    (0.0, 0.0, 1.0),      # blue
    (1.0, 1.0, 0.0),      # yellow
    (1.0, 0.0, 1.0),      # magenta
    (0.0, 1.0, 1.0),      # cyan
]


class DumpImage(Dump):
    def __init__(self, dump_id, group, style, every, path, args=(),
                 groupbit=1):
        super().__init__(dump_id, group, "image", every, path,
                         fields=["id", "type", "x", "y", "z"],
                         groupbit=groupbit)
        args = list(args)
        # positional: color attribute, diameter attribute
        self.color_attr = args[0] if args else "type"
        self.diam_attr = args[1] if len(args) > 1 else "type"
        self.width = self.height = 512
        self.theta = 60.0
        self.phi = 30.0
        self.zoom = 1.0
        self.adiam = None
        i = 2
        while i < len(args):
            key = args[i]
            if key == "size":
                self.width, self.height = int(args[i + 1]), int(args[i + 2])
                i += 3
            elif key == "view":
                self.theta, self.phi = float(args[i + 1]), float(args[i + 2])
                i += 3
            elif key == "zoom":
                self.zoom = float(args[i + 1])
                i += 2
            elif key == "adiam":
                self.adiam = float(args[i + 1])
                i += 2
            elif key in ("shiny", "box", "axes", "center", "up", "ssao"):
                # accepted, fixed defaults
                i += {"box": 3, "axes": 4, "center": 4, "up": 4,
                      "shiny": 2, "ssao": 4}[key]
            else:
                raise NotImplementedError(
                    f"dump image keyword {key!r} is not ported")

    def write(self, sim):
        s = sim.state
        tag = s.tag.cpu().numpy()
        valid = tag > 0
        if self.groupbit != 1:
            valid &= (s.gmask.cpu().numpy() & self.groupbit) > 0
        x = s.x.cpu().numpy().astype(np.float64)[valid]
        typ = s.type.cpu().numpy()[valid]
        lo = s.box.lo.cpu().numpy().astype(np.float64)
        hi = s.box.hi.cpu().numpy().astype(np.float64)
        if s.radius is not None:
            diam = 2.0 * s.radius.cpu().numpy().astype(np.float64)[valid]
        elif self.adiam is not None:
            diam = np.full(len(x), self.adiam)
        else:
            diam = np.ones(len(x))
        self.last_step = sim.step

        # orthographic camera (Image::view_params): view direction from
        # spherical angles, right/up in the view plane
        th, ph = math.radians(self.theta), math.radians(self.phi)
        vdir = np.array([math.sin(th) * math.cos(ph),
                         math.sin(th) * math.sin(ph),
                         math.cos(th)])
        upref = np.array([0.0, 0.0, 1.0])
        if abs(np.dot(upref, vdir)) > 0.999:
            upref = np.array([0.0, 1.0, 0.0])
        right = np.cross(upref, vdir)
        right /= np.linalg.norm(right)
        up = np.cross(vdir, right)

        ctr = 0.5 * (lo + hi)
        rel = x - ctr
        u = rel @ right
        v = rel @ up
        w = rel @ vdir
        extent = 0.5 * np.linalg.norm(hi - lo)
        scale = 0.5 * min(self.width, self.height) / extent * self.zoom

        W, H = self.width, self.height
        img = np.zeros((H, W, 3), np.float32)
        zbuf = np.full((H, W), -np.inf, np.float32)
        px = (u * scale + W / 2.0)
        py = (H / 2.0 - v * scale)
        pr = np.maximum(diam * 0.5 * scale, 1.0)
        light = np.array([0.45, -0.45, 0.77])

        order = np.argsort(w)          # back to front (painter + zbuf)
        for i in order:
            cx, cy, r = px[i], py[i], pr[i]
            x0, x1 = int(max(cx - r, 0)), int(min(cx + r + 1, W))
            y0, y1 = int(max(cy - r, 0)), int(min(cy + r + 1, H))
            if x0 >= x1 or y0 >= y1:
                continue
            yy, xx = np.mgrid[y0:y1, x0:x1]
            dx = (xx - cx) / r
            dy = (yy - cy) / r
            rr = dx * dx + dy * dy
            inside = rr < 1.0
            nz = np.sqrt(np.maximum(1.0 - rr, 0.0))
            zval = w[i] * scale + nz * r
            win = inside & (zval > zbuf[y0:y1, x0:x1])
            if not win.any():
                continue
            base = np.array(_TYPE_COLORS[(int(typ[i]) - 1)
                                         % len(_TYPE_COLORS)])
            ndotl = np.clip(dx * light[0] - dy * light[1] + nz * light[2],
                            0.0, 1.0)
            shade = (0.25 + 0.75 * ndotl)[..., None] * base
            spec = np.clip(ndotl - 0.95, 0, None) * 12.0
            shade = np.clip(shade + spec[..., None], 0.0, 1.0)
            patchz = zbuf[y0:y1, x0:x1]
            patchc = img[y0:y1, x0:x1]
            patchz[win] = zval[win]
            patchc[win] = shade[win]

        self._emit(img, W, H, sim.step)

    def _emit(self, img, W, H, step):
        path = self.path.replace("*", str(step))
        if not path.endswith(".ppm"):
            path = os.path.splitext(path)[0] + ".ppm"
        with open(path, "wb") as fh:
            fh.write(b"P6\n%d %d\n255\n" % (W, H))
            fh.write((img * 255).astype(np.uint8).tobytes())


class DumpMovie(DumpImage):
    """dump movie: every frame appended to ONE file as a raw P6 stream.

    The reference (src/dump_movie.cpp) pipes PPM frames into an ffmpeg
    child process; this image has no ffmpeg, so the stream itself is the
    artifact — the exact bytes the reference would feed the encoder.
    Convert offline with e.g.
    ``ffmpeg -f image2pipe -vcodec ppm -i dump.ppm out.mp4``.
    """

    def __init__(self, dump_id, group, style, every, path, args=(),
                 groupbit=1):
        super().__init__(dump_id, group, every=every, path=path,
                         style="movie", args=args, groupbit=groupbit)
        self._fh = None

    def _emit(self, img, W, H, step):
        if self._fh is None:
            path = self.path
            self._fh = open(path, "wb")
        self._fh.write(b"P6\n%d %d\n255\n" % (W, H))
        self._fh.write((img * 255).astype(np.uint8).tobytes())
        self._fh.flush()
