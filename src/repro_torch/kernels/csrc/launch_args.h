// The launchers' argument blocks, each declared once as a list of fields.
//
// A wrapper (kernels/*.py) passes a launcher one block of 8-byte fields,
// packed with Python's struct, and the stream: one converted argument
// instead of one per pointer and count.  From each field list come the C
// struct the launcher reads and the description "name:kind ..." that the
// library exports as <launcher>_args(); kernels/launch.py builds the
// packing format from that description and checks its field names against
// the ones the wrapper packs, once, when it first launches.  Kinds: p (a
// pointer), i (long long), d (double); every field is 8 bytes, so the
// struct has no padding.

#pragma once

#define LAUNCH_ARG_FIELD(type, name, kind) type name;
#define LAUNCH_ARG_TEXT(type, name, kind) #name ":" #kind " "
#define LAUNCH_ARG_COUNT(type, name, kind) +1
#define LAUNCH_ARG_SIZE(type, name, kind) \
  static_assert(sizeof(type) == 8, #name " must be an 8-byte field");

// Declares struct Struct from FIELDS and the exported description
// const char* describe() (inside extern "C").
#define LAUNCH_ARGS(Struct, FIELDS, describe)                           \
  struct Struct {                                                       \
    FIELDS(LAUNCH_ARG_FIELD)                                            \
  };                                                                    \
  FIELDS(LAUNCH_ARG_SIZE)                                               \
  static_assert(sizeof(Struct) == 8 * (0 FIELDS(LAUNCH_ARG_COUNT)),     \
                #Struct " must be unpadded 8-byte fields");             \
  extern "C" const char* describe() { return FIELDS(LAUNCH_ARG_TEXT); }
