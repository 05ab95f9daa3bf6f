"""Built-in scene builders and the chai-script loader."""
import numpy as np
import pytest

from cuda_pathtracer_tpu.scene.builder import get_scene


def test_outside_scene(reference_assets):
    s = get_scene('outside', asset_dirs=[reference_assets])
    assert len(s.objects) == 10          # 10 animated cubes
    assert len(s.planes) == 1
    assert len(s.point_lights) == 3
    assert s.interactive_depth == 5
    # the animation handler moves the cubes and invalidates
    p_before = s.objects[0].position.copy()
    s.update(None, 5.0)
    assert not np.allclose(s.objects[0].position, p_before)
    assert s.invalid


def test_sibenik_scene(reference_assets):
    s = get_scene('sibenik', asset_dirs=[reference_assets])
    assert len(s.spheres) == 2
    assert len(s.objects) == 3
    # the emissive cube is a real area light
    _, _, overrides = s.instances()
    tris, insts = s.extract_triangle_lights(overrides)
    assert len(tris) == 12


def test_sibenik_scene_without_assets():
    """The headline scene builds from procedural stand-ins alone (cathedral,
    statue, cube light) and finalises into device arrays."""
    s = get_scene('sibenik')
    assert len(s.objects) == 3 and len(s.spheres) == 2
    _, _, overrides = s.instances()
    tris, _ = s.extract_triangle_lights(overrides)
    assert len(tris) == 12               # the procedural cube light
    dyn = s.dynamic_arrays()
    assert dyn.world.tris.shape[0] == len(s._v0) > 150_000


def test_outside_scene_without_assets():
    s = get_scene('outside')
    assert len(s.objects) == 10
    assert len(s._v0) == 12              # one procedural cube model
    s.update(None, 5.0)
    assert s.invalid


def test_minecraft_scene(reference_assets):
    s = get_scene('minecraft', asset_dirs=[reference_assets])
    assert len(s.objects) == 1
    assert len(s._v0) > 5000


def test_chai_example_scene(reference_assets):
    s = get_scene(f'{reference_assets}/example_scene.chai',
                  asset_dirs=[reference_assets])
    assert len(s.objects) == 2
    assert len(s.materials) == 2
    assert abs(s.materials[0].refractive_index - 1.5) < 1e-6
    assert s.materials[1].emission == (1.0, 1.0, 1.0)
    # second object scaled to 0.2 and rotated pi/2 about y
    assert np.allclose(s.objects[1].scale, 0.2)
    assert abs(s.objects[1].rotation[1] - np.pi / 2) < 1e-3


def test_chai_full_language(tmp_path, reference_assets):
    """The chai loader is a real interpreter (sceneBuilder.h embeds the full
    chaiscript VM): loops, conditionals, user functions, arithmetic on
    variables and compound assignment all work."""
    script = tmp_path / 'ring.chai'
    script.write_text('''
def wave(x) {
    // taylor cosine via a while loop, exercising while/compound-assign
    var term = 1.0
    var sum = 0.0
    var k = 0
    while (k < 12) {
        sum += term
        term *= -x * x / ((2 * k + 1) * (2 * k + 2))
        ++k
    }
    return sum
}

def ring_object(model, i, n, r) {
    var obj = GameObject(model)
    var ang = 2.0 * 3.14159265 * i / n
    obj.position.x = r * wave(ang)
    if (i % 2 == 0) {
        obj.scale = make_float3(0.5, 0.5, 0.5)
    } else {
        obj.scale = make_float3(0.25)
    }
    return obj
}

var mat = DiffuseMaterial(make_float3(0.8, 0.2, 0.2))
var mid = scene_add_material(mat)
var model = scene_add_model("cube.obj", 1, make_float3(0,0,0),
                            make_float3(0,0,0), mid, false)
var n = 8
for (var i = 0; i < n; ++i) {
    scene_add_object(ring_object(model, i, n, 10.0))
}
''')
    s = get_scene(str(script), asset_dirs=[reference_assets])
    assert len(s.objects) == 8
    assert abs(s.objects[0].position[0] - 10.0) < 1e-3
    assert abs(s.objects[4].position[0] + 10.0) < 1e-3
    assert np.allclose(s.objects[0].scale, 0.5)
    assert np.allclose(s.objects[1].scale, 0.25)


def test_chai_runaway_script_fails_fast(tmp_path):
    loop = tmp_path / 'loop.chai'
    loop.write_text('var i = 0\nwhile (true) { i += 1 }\n')
    with pytest.raises(RuntimeError, match='exceeded'):
        get_scene(str(loop))


def test_chai_rejects_bad_script(tmp_path):
    bad = tmp_path / 'bad.chai'
    bad.write_text('var x = not_a_function(1)\n')
    with pytest.raises(RuntimeError, match='bad.chai:1'):
        get_scene(str(bad))


def test_chai_rejects_sandbox_escape(tmp_path):
    # attribute-chain escapes of the empty-__builtins__ env must be refused
    # outright (the reference's chaiscript VM cannot run host code either)
    evil = tmp_path / 'evil.chai'
    evil.write_text(
        "var x = make_float3(1).__class__.__mro__[1].__subclasses__()\n")
    with pytest.raises(RuntimeError, match='evil.chai:1'):
        get_scene(str(evil))


def test_chai_rejects_import(tmp_path):
    evil = tmp_path / 'imp.chai'
    evil.write_text("import os\n")
    with pytest.raises(RuntimeError, match='imp.chai:1'):
        get_scene(str(evil))
