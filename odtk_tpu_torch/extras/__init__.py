"""Deployment extras of the port: multi-stream video inference,
the anchor tables for C++ configs, the CLI harness (``test.sh``) and the
C++ samples (``cppapi/``)."""
