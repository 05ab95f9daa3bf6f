"""Render the built-in scenes to screenshots/.

    python tools/make_screenshots.py [ASSET_DIR ...]

Scenes whose assets are not found fall back to their procedural stand-ins
(scene/builder.py); the scripted example scene is rendered only when
example_scene.chai is on the asset path.
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

from cuda_pathtracer_tpu.scene.builder import get_scene  # noqa: E402
from cuda_pathtracer_tpu.models.pathtracer import Pathtracer  # noqa: E402
from cuda_pathtracer_tpu.models.raytracer import Raytracer  # noqa: E402
from cuda_pathtracer_tpu.models import film  # noqa: E402
from cuda_pathtracer_tpu.scene import state  # noqa: E402
from cuda_pathtracer_tpu.core.camera import Camera  # noqa: E402
from cuda_pathtracer_tpu.utils.image import save_png  # noqa: E402

W, H = 320, 240
SPP = 24
ASSETS = sys.argv[1:]


def shoot(name, scene, cam, out, spp=SPP, blur=False, t=0.0, mode='path'):
    t0 = time.time()
    if mode == 'ray':
        app = Raytracer(scene, W, H)
        scene.update(None, t)
        app.render(cam, t, 0.0, should_clear=False)
        app.finish()
    else:
        app = Pathtracer(scene, W, H)
        scene.update(None, t)
        app.render(cam, t, 0.0, should_clear=True)
        while app.sample_idx < spp:
            app.render(cam, t, 0.0, should_clear=False)
        app.finish()
    img = film.to_uint8(app.image(blur=blur))
    save_png(np.asarray(img), out)
    e = app.energy() if hasattr(app, 'energy') else ('-',)
    print(f"{name}: {time.time()-t0:.0f}s -> {out} energy={e[0] if e else ''}",
          flush=True)
    return app


saves = [os.path.join(d, 'save.txt') for d in ASSETS]
cam_out = state.read_state(next((p for p in saves if os.path.exists(p)),
                                'save.txt'))
sc = get_scene('outside', asset_dirs=ASSETS)
shoot('outside-path', sc, cam_out, 'screenshots/outside_path.png', t=0.0)
sc2 = get_scene('outside', asset_dirs=ASSETS)
shoot('outside-ray', sc2, cam_out, 'screenshots/outside_ray.png', mode='ray')

cam_sib = Camera.create([0.0, 5.0, -16.0], [0.0, 0.0, 1.0], 1.5, 12.0, 0.0)
sc = get_scene('sibenik', asset_dirs=ASSETS)
app = shoot('sibenik', sc, cam_sib, 'screenshots/sibenik.png')
save_png(np.asarray(film.to_uint8(app.image(blur=True))),
         'screenshots/sibenik_blur.png')
print('sibenik blur saved', flush=True)

cam_mc = Camera.create([0.0, 22.0, -60.0], [0.0, -0.25, 1.0], 1.5, 30.0, 0.0)
sc = get_scene('minecraft', asset_dirs=ASSETS)
shoot('minecraft', sc, cam_mc, 'screenshots/minecraft.png')

chai = [os.path.join(d, 'example_scene.chai') for d in ASSETS]
chai = [p for p in chai if os.path.exists(p)]
if chai:
    cam_chai = Camera.create([0.0, 12.0, -25.0], [0.0, 0.0, 1.0], 1.5, 20.0,
                             0.0)
    sc = get_scene(chai[0], asset_dirs=ASSETS)
    shoot('example-chai', sc, cam_chai, 'screenshots/example_scene.png')
