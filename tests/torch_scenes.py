"""Scenes shared by the port's test files (imported as a module of tests/,
which pytest puts on the path)."""
import numpy as np

from mitsuba_tpu_torch.scene import shapes
from mitsuba_tpu_torch.scene.builder import SceneDesc, compile_scene


def tie_scene(device):
    """Coincident triangles in the plane z = 0, among 120 small ones far
    below: A at triangles 5, 37 (one cluster, lanes 5 and 5 + 32) and 70
    (the next cluster); B at 40 (lane 8 + 32 of cluster 0) and 66 (lane 2
    of cluster 1); C at 80 and 112 (lanes 16 and 16 + 32 of cluster 1).
    120 triangles keep the author's order (Morton order starts past 256);
    compiled on `device`: the scene of the tie batches of
    test_torch_kernels.py (on the card) and test_torch_ordered.py."""
    rs = np.random.RandomState(3)
    tris = rs.rand(120, 3, 3) * 0.1 + np.array([0.0, 0.0, -50.0])
    quad = lambda x0: np.array([[x0, -1.0, 0.0], [x0 + 2.0, -1.0, 0.0],
                                [x0, 1.0, 0.0]])
    for ids, x0 in (((5, 37, 70), -3.0), ((40, 66), -1.0), ((80, 112), 1.0)):
        for i in ids:
            tris[i] = quad(x0)
    desc = SceneDesc()
    desc.add_shape(shapes.Mesh(tris.reshape(-1, 3),
                               np.arange(360).reshape(120, 3)),
                   material=desc.add_material(kind="diffuse"))
    return compile_scene(desc, device=device)
