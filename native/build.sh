#!/bin/sh
# Build the native helpers into proxsdp_tpu/utils/_native.so (written under
# a temporary name and renamed into place, so a killed build leaves no
# broken library)
set -e
cd "$(dirname "$0")"
tmp="../proxsdp_tpu/utils/_native.so.tmp$$"
g++ -O2 -shared -fPIC -std=c++17 -o "$tmp" parse_sdpa.cpp
mv -f "$tmp" ../proxsdp_tpu/utils/_native.so
echo "built proxsdp_tpu/utils/_native.so"
