"""Pure tensor primitives: encoding, rays, sampling, compositing."""
