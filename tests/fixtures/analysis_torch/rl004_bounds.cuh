// RL004 fixture header: a block size the including file's launches use
#pragma once

namespace fx {
constexpr int WIDE = 512;
constexpr int NARROW = 128;
}  // namespace fx
