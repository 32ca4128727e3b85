"""Native (C++) host components of the port: the JPEG decoder of the frame
pipeline (jpeg.py), with committed JPEG fixtures and their manifest
(fixtures/) for checking it on a machine without an encoder."""
