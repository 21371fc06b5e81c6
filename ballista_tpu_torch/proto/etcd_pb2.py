# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: etcd.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\netcd.proto\x12\x0c\x65tcdserverpb\"\\\n\x0eResponseHeader\x12\x12\n\ncluster_id\x18\x01 \x01(\x04\x12\x11\n\tmember_id\x18\x02 \x01(\x04\x12\x10\n\x08revision\x18\x03 \x01(\x03\x12\x11\n\traft_term\x18\x04 \x01(\x04\"u\n\x08KeyValue\x12\x0b\n\x03key\x18\x01 \x01(\x0c\x12\x17\n\x0f\x63reate_revision\x18\x02 \x01(\x03\x12\x14\n\x0cmod_revision\x18\x03 \x01(\x03\x12\x0f\n\x07version\x18\x04 \x01(\x03\x12\r\n\x05value\x18\x05 \x01(\x0c\x12\r\n\x05lease\x18\x06 \x01(\x03\"=\n\x0cRangeRequest\x12\x0b\n\x03key\x18\x01 \x01(\x0c\x12\x11\n\trange_end\x18\x02 \x01(\x0c\x12\r\n\x05limit\x18\x03 \x01(\x03\"\x7f\n\rRangeResponse\x12,\n\x06header\x18\x01 \x01(\x0b\x32\x1c.etcdserverpb.ResponseHeader\x12#\n\x03kvs\x18\x02 \x03(\x0b\x32\x16.etcdserverpb.KeyValue\x12\x0c\n\x04more\x18\x03 \x01(\x08\x12\r\n\x05\x63ount\x18\x04 \x01(\x03\"7\n\nPutRequest\x12\x0b\n\x03key\x18\x01 \x01(\x0c\x12\r\n\x05value\x18\x02 \x01(\x0c\x12\r\n\x05lease\x18\x03 \x01(\x03\";\n\x0bPutResponse\x12,\n\x06header\x18\x01 \x01(\x0b\x32\x1c.etcdserverpb.ResponseHeader\"4\n\x12\x44\x65leteRangeRequest\x12\x0b\n\x03key\x18\x01 \x01(\x0c\x12\x11\n\trange_end\x18\x02 \x01(\x0c\"T\n\x13\x44\x65leteRangeResponse\x12,\n\x06header\x18\x01 \x01(\x0b\x32\x1c.etcdserverpb.ResponseHeader\x12\x0f\n\x07\x64\x65leted\x18\x02 \x01(\x03\",\n\x11LeaseGrantRequest\x12\x0b\n\x03TTL\x18\x01 \x01(\x03\x12\n\n\x02ID\x18\x02 \x01(\x03\"j\n\x12LeaseGrantResponse\x12,\n\x06header\x18\x01 \x01(\x0b\x32\x1c.etcdserverpb.ResponseHeader\x12\n\n\x02ID\x18\x02 \x01(\x03\x12\x0b\n\x03TTL\x18\x03 \x01(\x03\x12\r\n\x05\x65rror\x18\x04 \x01(\t\" \n\x12LeaseRevokeRequest\x12\n\n\x02ID\x18\x01 \x01(\x03\"C\n\x13LeaseRevokeResponse\x12,\n\x06header\x18\x01 \x01(\x0b\x32\x1c.etcdserverpb.ResponseHeader\"#\n\x15LeaseKeepAliveRequest\x12\n\n\x02ID\x18\x01 \x01(\x03\"_\n\x16LeaseKeepAliveResponse\x12,\n\x06header\x18\x01 \x01(\x0b\x32\x1c.etcdserverpb.ResponseHeader\x12\n\n\x02ID\x18\x02 \x01(\x03\x12\x0b\n\x03TTL\x18\x03 \x01(\x03\"*\n\x0bLockRequest\x12\x0c\n\x04name\x18\x01 \x01(\x0c\x12\r\n\x05lease\x18\x02 \x01(\x03\"I\n\x0cLockResponse\x12,\n\x06header\x18\x01 \x01(\x0b\x32\x1c.etcdserverpb.ResponseHeader\x12\x0b\n\x03key\x18\x02 \x01(\x0c\"\x1c\n\rUnlockRequest\x12\x0b\n\x03key\x18\x01 \x01(\x0c\">\n\x0eUnlockResponse\x12,\n\x06header\x18\x01 \x01(\x0b\x32\x1c.etcdserverpb.ResponseHeaderb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'etcd_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _RESPONSEHEADER._serialized_start=28
  _RESPONSEHEADER._serialized_end=120
  _KEYVALUE._serialized_start=122
  _KEYVALUE._serialized_end=239
  _RANGEREQUEST._serialized_start=241
  _RANGEREQUEST._serialized_end=302
  _RANGERESPONSE._serialized_start=304
  _RANGERESPONSE._serialized_end=431
  _PUTREQUEST._serialized_start=433
  _PUTREQUEST._serialized_end=488
  _PUTRESPONSE._serialized_start=490
  _PUTRESPONSE._serialized_end=549
  _DELETERANGEREQUEST._serialized_start=551
  _DELETERANGEREQUEST._serialized_end=603
  _DELETERANGERESPONSE._serialized_start=605
  _DELETERANGERESPONSE._serialized_end=689
  _LEASEGRANTREQUEST._serialized_start=691
  _LEASEGRANTREQUEST._serialized_end=735
  _LEASEGRANTRESPONSE._serialized_start=737
  _LEASEGRANTRESPONSE._serialized_end=843
  _LEASEREVOKEREQUEST._serialized_start=845
  _LEASEREVOKEREQUEST._serialized_end=877
  _LEASEREVOKERESPONSE._serialized_start=879
  _LEASEREVOKERESPONSE._serialized_end=946
  _LEASEKEEPALIVEREQUEST._serialized_start=948
  _LEASEKEEPALIVEREQUEST._serialized_end=983
  _LEASEKEEPALIVERESPONSE._serialized_start=985
  _LEASEKEEPALIVERESPONSE._serialized_end=1080
  _LOCKREQUEST._serialized_start=1082
  _LOCKREQUEST._serialized_end=1124
  _LOCKRESPONSE._serialized_start=1126
  _LOCKRESPONSE._serialized_end=1199
  _UNLOCKREQUEST._serialized_start=1201
  _UNLOCKREQUEST._serialized_end=1229
  _UNLOCKRESPONSE._serialized_start=1231
  _UNLOCKRESPONSE._serialized_end=1293
# @@protoc_insertion_point(module_scope)
