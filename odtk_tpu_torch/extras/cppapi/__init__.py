"""The C++ deployment samples over AOTInductor packages; ``build``
configures and builds them."""
