"""The benchmark's plain reference: the viewer's path tracer for sphere
scenes in plain PyTorch, written from the upstream shader's semantics.

It imports torch and numpy only, and nothing of the program under test: it
works the sky image, its sampling tables, the camera basis, the light
directions and its own acceleration grid out again from the inputs that the
harness hands both sides.
"""
