"""The benchmark's plain reference: the viewer's path tracer in plain
PyTorch, written from the upstream shader's semantics.

camera.py, fmath.py and sky.py are shared by every scene kind; tracer.py
and grid.py are the sphere kind's reference scene. Another kind adds its
own files beside them, reached through its generator's reference_scene.

It imports torch and numpy only, and nothing of the program under test: it
works the sky image, its sampling tables, the camera basis, the light
directions and its own acceleration grid out again from the inputs that the
harness hands both sides.
"""
